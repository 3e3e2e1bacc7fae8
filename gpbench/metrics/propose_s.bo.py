"""Seconds of propose_next per BO step (a harness span, synchronized on
each side)."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "s/step"
LAYER = "BO loop"
SOURCE = "program_span"
MOVES = "bo_step_s"


def read(rec):
    return None if not rec.spans.get('propose') else sum(rec.spans['propose']) / len(rec.spans['propose'])
