"""Share of its bytes bound of the covariance assembly's theta-VJP (K2) at
the cell's shapes: see metrics_lib.assembly_roofline."""

from gpbench import metrics_lib as lib  # noqa: F401

UNIT = "%"
LAYER = "covariance kernels"
SOURCE = "device_trace"
MOVES = "fit_s"


def read(rec):
    return lib.assembly_roofline(rec, 'K2')
