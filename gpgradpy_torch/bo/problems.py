"""Test objectives with analytic gradients (copy of
``gpgradpy_tpu/bo/problems.py``; the papers' experiments use Rosenbrock with
a=10 in d=5/10/20)."""

from __future__ import annotations

import numpy as np


def rosenbrock(x, a: float = 10.0):
    """f = sum a (x_{i+1} - x_i^2)^2 + (1 - x_i)^2; value and gradient."""
    x = np.atleast_2d(np.asarray(x, float))
    d = x.shape[1]
    t1 = x[:, 1:] - x[:, :-1] ** 2
    t2 = 1.0 - x[:, :-1]
    f = np.sum(a * t1 ** 2 + t2 ** 2, axis=1)
    g = np.zeros_like(x)
    g[:, :-1] += -4 * a * t1 * x[:, :-1] - 2 * t2
    g[:, 1:] += 2 * a * t1
    return f, g


def sin_1d(x):
    """f = sin(x) + sin(10x/3) (plt_surr_1d.py:57-65)."""
    x = np.atleast_2d(np.asarray(x, float))
    x1 = x[:, 0]
    f = np.sin(x1) + np.sin(10 * x1 / 3.0)
    g = (np.cos(x1) + (10.0 / 3.0) * np.cos(10 * x1 / 3.0))[:, None]
    return f, g


PROBLEMS = {
    "rosenbrock": rosenbrock,
    "sin_1d": sin_1d,
}
