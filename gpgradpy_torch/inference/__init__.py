from . import diagnostics, draws, nuts, smc, vi  # noqa: F401
