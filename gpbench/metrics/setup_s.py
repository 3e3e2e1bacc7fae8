"""Process start to the first timed request: imports, CUDA start, the K1/K2
library's load (its nvcc build on a checkout's first run), the data from
the seed and one request of each shape of the cell."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "s"
LAYER = "harness set-up"
SOURCE = "host_clock"
MOVES = "setup_s"


def read(rec):
    return rec.setup_s
