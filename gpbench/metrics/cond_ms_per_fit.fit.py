"""Device ms per fit of every kernel launched inside ops/linalg.cond_eigh
and cond_fro_w_chol (a profiler range the harness puts around them)."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "ms"
LAYER = "condition number"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(rec):
    t = (rec.profile or {}).get('ranges_device_s', {}).get('gpbench.cond')
    return None if not t else lib.per_request(rec, 1e3 * t)
