"""Device-busy ms per eval_model request over the profiled requests."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "ms"
LAYER = "predict"
SOURCE = "device_trace"
MOVES = "predict_ms.p95"


def read(rec):
    return None if rec.profile is None else lib.per_request(rec, 1e3 * rec.profile['busy_s'])
