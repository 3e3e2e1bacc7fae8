"""Polynomial mean functions with closed-form GLS coefficients
(counterpart of ``gpgradpy_tpu/model/mean.py``).

    beta = (V^T K^-1 V)^-1 V^T K^-1 y

is computed with differentiable solves, so autograd carries its
hyperparameter gradient.  The factor may carry a leading batch dimension;
the basis ``V`` and the data are shared by every row.
"""

from __future__ import annotations

import torch

from ..ops import linalg


def n_beta_coeff(mean_fun_type: str, dim: int) -> int:
    if mean_fun_type == "poly_ord_0":
        return 1
    if mean_fun_type == "poly_ord_1":
        return 1 + dim
    raise ValueError(f"mean_fun_type = {mean_fun_type} not available")


def calc_vand(mean_fun_type: str, x: torch.Tensor):
    """Vandermonde matrix (n, n_beta) and its x-gradient (dim, n, n_beta)."""
    n, dim = x.shape
    nb = n_beta_coeff(mean_fun_type, dim)
    vand = torch.ones((n, 1), dtype=x.dtype, device=x.device)
    vand_grad = torch.zeros((dim, n, nb), dtype=x.dtype, device=x.device)
    if nb > 1:
        vand = torch.cat([vand, x], dim=1)
        eye = torch.eye(dim, dtype=x.dtype, device=x.device)
        vand_grad[:, :, 1:] = eye[:, None, :].expand(dim, n, dim)
    return vand, vand_grad


def calc_aug_vand(mean_fun_type: str, x: torch.Tensor, use_grad: bool,
                  idx_grad=None):
    """Basis rows followed by basis-gradient rows grouped by coordinate,
    matching the data-vector layout."""
    vand, vand_grad = calc_vand(mean_fun_type, x)
    if not use_grad:
        return vand
    if idx_grad is not None:
        vand_grad = vand_grad[:, torch.as_tensor(idx_grad, device=x.device), :]
    d, g, nb = vand_grad.shape
    return torch.cat([vand, vand_grad.reshape(d * g, nb)], dim=0)


def eval_mean_fun(mean_fun_type: str, x: torch.Tensor, beta: torch.Tensor):
    """Mean value (n,), gradient (n, dim) and Hessian (n, dim, dim)."""
    n, dim = x.shape
    vand, vand_grad = calc_vand(mean_fun_type, x)
    mval = vand @ beta
    mgrad = torch.einsum("dnb,b->nd", vand_grad, beta)
    mhess = torch.zeros((n, dim, dim), dtype=x.dtype, device=x.device)
    return mval, mgrad, mhess


def _spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of the small normal-equations system A x = b
    (A (..., nb, nb), b (..., nb)).  A row whose A is not positive definite
    yields NaN, as ``jnp.linalg.cholesky`` does, instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def gls_beta_precon(vand_aug: torch.Tensor, fac: linalg.CholFac,
                    pvec: torch.Tensor, data_vec: torch.Tensor):
    """GLS beta where K^-1 b = P^-1 M^-1 P^-1 b (preconditioned factor), and
    the fitted mean vector V beta.  Shapes: vand_aug (n, nb), pvec (..., n),
    data_vec (n,); returns beta (..., nb) and the mean (..., n)."""
    Vp = vand_aug / pvec[..., :, None]
    invM_Vp = linalg.cho_solve(fac, Vp)
    A = Vp.transpose(-1, -2) @ invM_Vp
    rhs = (invM_Vp.transpose(-1, -2) @ (data_vec / pvec)[..., None])[..., 0]
    beta = _spd_solve(A, rhs)
    return beta, beta @ vand_aug.T
