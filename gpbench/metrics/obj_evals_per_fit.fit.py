"""Likelihood evaluations per fit: calls of model/likelihood.calc_lkd, the
entry through which both optimizers (L-BFGS and SLSQP), the start scan,
the condition-number telemetry and the closed form evaluate -ln L,
counted by the harness over the window's fits."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "count"
LAYER = "optimizer"
SOURCE = "program_counter"
MOVES = "fit_s"


def read(rec):
    return None if not rec.latencies_s or 'lkd_calls' not in rec.counters else rec.counters['lkd_calls'] / len(rec.latencies_s)
