"""Share of the profiled BO steps' wall time in which the device ran nothing."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "bo_step_s"


def read(rec):
    return lib.idle_share(rec)
