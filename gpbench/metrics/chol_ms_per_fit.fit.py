"""Device ms per fit in the Cholesky and in the triangular solves and
products around it (its autograd backward among them), from the profiled
fits, by kernel-name keywords."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "ms"
LAYER = "likelihood and factorization"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(rec):
    t = lib.device_s_of(rec, lib.FACTORIZATION)
    return None if not t else lib.per_request(rec, 1e3 * t)
