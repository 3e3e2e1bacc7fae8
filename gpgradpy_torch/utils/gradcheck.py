"""Interactive finite-difference gradient checker (the port's copy of
``gpgradpy_tpu/utils/gradcheck.py``, numpy only).

Its function's name starts with ``test_``: import it under another name in
a test module, or pytest collects it as a test.
"""

from __future__ import annotations

import numpy as np


def test_grad_calc(x0_in, fh_fun, fh_grad, eps: float = 1e-8,
                   print_calc: bool = True, calc_cent_diff: bool = True):
    """Compare fh_grad(x0) against a finite difference of fh_fun.

    Returns (fd_grad, grad_x0)."""
    x0 = np.atleast_1d(np.asarray(x0_in, dtype="float64"))
    dim = x0.size

    fun_x0 = np.atleast_1d(fh_fun(x0))
    grad_x0 = np.atleast_1d(np.asarray(fh_grad(x0)))
    n_fun = fun_x0.size
    fd_grad = np.zeros((n_fun, dim))

    for i in range(dim):
        xp = x0.copy()
        xp[i] += eps
        fp = np.atleast_1d(fh_fun(xp))
        if calc_cent_diff:
            xm = x0.copy()
            xm[i] -= eps
            fm = np.atleast_1d(fh_fun(xm))
            fd_grad[:, i] = (fp - fm) / (2 * eps)
        else:
            fd_grad[:, i] = (fp - fun_x0) / eps

    if grad_x0.ndim == 1:
        assert n_fun == 1, "If n_fun > 1 then fh_grad must return a 2D array"
        fd_grad = fd_grad[0, :]

    if print_calc:
        print(f"FD test: eval x0: {fun_x0}, x0 = {x0}")
        print(f" FD:   {fd_grad}")
        print(f" Grad: {grad_x0}")
        print(f" Diff: {grad_x0 - fd_grad}")

    return fd_grad, grad_x0
