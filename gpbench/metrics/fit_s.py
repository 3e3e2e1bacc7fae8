"""Seconds per hyperparameter fit: the window over the fits it completed."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "s"
LAYER = "facade fit"
SOURCE = "host_clock"
MOVES = "fit_s"


def read(rec):
    return lib.window_mean(rec)
