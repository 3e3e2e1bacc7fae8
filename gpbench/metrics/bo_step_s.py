"""Seconds per BO explore step: the window over the steps it completed."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "s"
LAYER = "BO loop"
SOURCE = "host_clock"
MOVES = "bo_step_s"


def read(rec):
    return lib.window_mean(rec)
