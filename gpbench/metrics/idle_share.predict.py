"""Share of the profiled requests' wall time in which the device ran
nothing."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "%"
LAYER = "device"
SOURCE = "device_trace"
MOVES = "predict_ms.p95"


def read(rec):
    return lib.idle_share(rec)
