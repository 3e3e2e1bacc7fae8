"""Rosenbrock function with a = 10 (the paper's test problem), its value
and gradient, in NumPy float64."""

import numpy as np


def rosenbrock(x, a: float = 10.0):
    """f = sum_i a (x_{i+1} - x_i^2)^2 + (1 - x_i)^2 for rows x (m, d);
    returns (f (m,), grad (m, d))."""
    x = np.atleast_2d(np.asarray(x, np.float64))
    t1 = x[:, 1:] - x[:, :-1] ** 2
    t2 = 1.0 - x[:, :-1]
    f = np.sum(a * t1 ** 2 + t2 ** 2, axis=1)
    g = np.zeros_like(x)
    g[:, :-1] += -4.0 * a * t1 * x[:, :-1] - 2.0 * t2
    g[:, 1:] += 2.0 * a * t1
    return f, g
