"""Latin hypercube sampling of the fit's start points, on the host
(counterpart of ``gpgradpy_tpu/fit/lhs.py::lhs_sample``: the same scipy
generator with the same seed, so both packages start from the same points)."""

from __future__ import annotations

import numpy as np
from scipy.stats import qmc


def lhs_sample(n: int, lb: np.ndarray, ub: np.ndarray, seed: int = 1) -> np.ndarray:
    """Seeded LHS in [lb, ub], shape (n, d); in 1-D a linspace without the
    boundary nodes."""
    lb = np.asarray(lb, float)
    ub = np.asarray(ub, float)
    d = lb.size
    if d == 1:
        return np.linspace(lb[0], ub[0], n + 2)[1:-1, None]
    u = qmc.LatinHypercube(d=d, seed=seed).random(n)
    return lb + u * (ub - lb)
