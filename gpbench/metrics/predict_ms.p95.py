"""95th percentile of the latency of every eval_model request of the
window, from the call to its results on the host."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "ms"
LAYER = "predict"
SOURCE = "host_clock"
MOVES = "predict_ms.p95"


def read(rec):
    return None if not rec.latencies_s else 1e3 * float(lib.np.percentile(rec.latencies_s, 95))
