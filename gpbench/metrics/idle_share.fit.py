"""Share of the profiled fits' wall time in which the device ran nothing."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(rec):
    return lib.idle_share(rec)
