"""Radial kernels and gradient-enhanced covariance blocks in plain PyTorch.

Counterpart of ``gpgradpy_tpu/ops/kernels.py``.  All three kernel families
(squared exponential, Matern-5/2, rational quadratic) are radial,
``k(x1, x2) = phi(W)`` with ``W = sum_i theta_i (x1_i - x2_i)**2``, so every
block of the gradient-enhanced covariance is one formula in the scalar
derivatives phi', phi'', phi''':

    K[val,  val ]          = phi
    K[d/dx1_a, val]        =  2 theta_a R_a phi'
    K[val,  d/dx2_b]       = -2 theta_b R_b phi'
    K[d/dx1_a, d/dx2_b]    = -2 theta_a delta_ab phi' - 4 theta_a theta_b R_a R_b phi''

with ``R_a = x1_a - x2_a``.  This module is the CPU path of the port and
the plain version that the CUDA kernels of ``ops/cuda_assembly.py`` are held
against.  ``theta`` may carry a leading batch dimension ``(B, d)`` (and the
RatQu ``alpha`` a matching ``(B,)``); the block tensors then gain the same
leading dimension.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_SQRT5 = 5.0 ** 0.5


def _per_row(alpha, W):
    """Broadcast a per-batch-row scalar against (..., n1, n2)."""
    if isinstance(alpha, torch.Tensor) and alpha.ndim > 0:
        return alpha[..., None, None]
    return alpha


def _phi_sq_exp(W, alpha):
    phi = torch.exp(-W)
    return phi, -phi, phi, -phi


def _phi_matern52(W, alpha):
    """phi''' ~ 1/nu as W -> 0; it only ever multiplies odd products of R,
    which vanish there, so it is guarded to 0 on the diagonal.  The double
    ``where`` keeps autograd finite at W = 0."""
    pos = W > 0.0
    w_safe = torch.where(pos, W, torch.ones_like(W))
    nu = torch.where(pos, torch.sqrt(w_safe), torch.zeros_like(W))
    e = torch.exp(-_SQRT5 * nu)
    phi = (1.0 + _SQRT5 * nu + (5.0 / 3.0) * W) * e
    phi1 = -(5.0 / 6.0) * (1.0 + _SQRT5 * nu) * e
    phi2 = (25.0 / 12.0) * e
    inv_nu = torch.where(pos, 1.0 / torch.where(pos, nu, torch.ones_like(nu)),
                         torch.zeros_like(nu))
    phi3 = -(25.0 * _SQRT5 / 24.0) * e * inv_nu
    return phi, phi1, phi2, phi3


def _phi_rat_quad(W, alpha):
    a = _per_row(alpha, W)
    B = 1.0 + W / a
    phi = B ** (-a)
    phi1 = -(B ** (-a - 1.0))
    phi2 = (1.0 + 1.0 / a) * B ** (-a - 2.0)
    phi3 = -(1.0 + 1.0 / a) * (1.0 + 2.0 / a) * B ** (-a - 3.0)
    return phi, phi1, phi2, phi3


PHI = {"SqExp": _phi_sq_exp, "Ma5f2": _phi_matern52, "RatQu": _phi_rat_quad}


def theta2gamma(kernel_type: str, theta):
    """sqrt of the grad-grad block diagonal of the correlation matrix,
    sqrt(-2 phi'(0) theta) for each family."""
    if kernel_type == "Ma5f2":
        return torch.sqrt((5.0 / 3.0) * theta)
    return torch.sqrt(2.0 * theta)


def gamma2theta(kernel_type: str, gamma):
    """Inverse of ``theta2gamma``."""
    if kernel_type == "Ma5f2":
        return (3.0 / 5.0) * gamma ** 2
    return 0.5 * gamma ** 2


def weighted_sqdist(R, theta):
    """W[..., i, j] = sum_d theta[..., d] R[d, i, j]**2."""
    return torch.einsum("...d,dij->...ij", theta, R * R)


def kern_base(kernel_type: str, R, theta, alpha=None):
    """Gradient-free kernel matrix, shape (..., n1, n2)."""
    phi, *_ = PHI[kernel_type](weighted_sqdist(R, theta), alpha)
    return phi


def kern_block_tensor(kernel_type: str, R, theta, alpha=None):
    """Block tensor G of shape (..., 1+d, 1+d, n1, n2): G[0, 0] the base
    kernel, G[a, 0] its derivative in x1_{a-1}, G[0, b] in x2_{b-1}, G[a, b]
    the mixed second derivative."""
    dim = R.shape[0]
    W = weighted_sqdist(R, theta)
    phi, phi1, phi2, _ = PHI[kernel_type](W, alpha)

    thR = theta[..., :, None, None] * R                     # (..., d, n1, n2)
    g_row = 2.0 * thR * phi1[..., None, :, :]
    g_col = -2.0 * thR * phi1[..., None, :, :]
    gg = -4.0 * thR[..., :, None, :, :] * thR[..., None, :, :, :] \
        * phi2[..., None, None, :, :]                      # (..., d, d, n1, n2)
    eye = torch.eye(dim, dtype=R.dtype, device=R.device)
    gg = gg + eye[:, :, None, None] * (
        -2.0 * theta[..., :, None, None, None] * phi1[..., None, None, :, :])

    top = torch.cat([phi[..., None, :, :], g_col], dim=-3)         # (..., 1+d, n1, n2)
    bot = torch.cat([g_row[..., :, None, :, :], gg], dim=-3)       # (..., d, 1+d, n1, n2)
    return torch.cat([top[..., None, :, :, :], bot], dim=-4)


def _grad_rows(n: int, dim: int, idx, device):
    """Row indices of a flattened block matrix that keeps every value row and
    the gradient rows of the points in ``idx``."""
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.long, device=device)
    return torch.cat([torch.arange(n, device=device)]
                     + [a * n + idx for a in range(1, dim + 1)])


def flatten_blocks(G, idx_g1=None, idx_g2=None):
    """(..., 1+d, 1+d, n1, n2) -> (..., n1 + g1*d, n2 + g2*d): values first,
    then the gradient blocks grouped by coordinate.  ``idx_g1`` / ``idx_g2``
    select the points that contribute gradient rows / columns."""
    A, n1, n2 = G.shape[-3], G.shape[-2], G.shape[-1]
    K = G.transpose(-3, -2).reshape(*G.shape[:-4], A * n1, A * n2)
    if idx_g1 is not None:
        K = K.index_select(-2, _grad_rows(n1, A - 1, idx_g1, G.device))
    if idx_g2 is not None:
        K = K.index_select(-1, _grad_rows(n2, A - 1, idx_g2, G.device))
    return K


def kern_grad(kernel_type: str, R, theta, alpha=None,
              idx_g1: Optional[np.ndarray] = None,
              idx_g2: Optional[np.ndarray] = None):
    """Gradient-enhanced kernel matrix, shape (..., n1 + g1*d, n2 + g2*d)."""
    G = kern_block_tensor(kernel_type, R, theta, alpha)
    return flatten_blocks(G, idx_g1, idx_g2)


def kern_mat(kernel_type: str, R, theta, alpha=None, use_grad: bool = True,
             idx_g1=None, idx_g2=None):
    """Gradient-enhanced or base kernel matrix."""
    if use_grad:
        return kern_grad(kernel_type, R, theta, alpha, idx_g1, idx_g2)
    return kern_base(kernel_type, R, theta, alpha)


def kern_hess_x(kernel_type: str, R, theta, alpha=None, use_grad: bool = True,
                idx_g2=None):
    """Second derivative of the (gradient-enhanced) cross-kernel in its first
    argument x1, for surrogate Hessians (one hyperparameter row).

    Returns shape (dim, n1*dim, n2*(1+dim)) when ``use_grad`` (third
    derivatives in the gradient columns), else (dim, n1*dim, n2).
    """
    dim, n1, n2 = R.shape
    W = weighted_sqdist(R, theta)
    phi, phi1, phi2, phi3 = PHI[kernel_type](W, alpha)

    thR = theta[:, None, None] * R                       # (d, n1, n2)
    eye = torch.eye(dim, dtype=R.dtype, device=R.device)

    # d2 k / dx1_i dx1_k = 4 th_i th_k R_i R_k phi'' + 2 th_i d_ik phi'
    val_cols = (4.0 * thR[None, :] * thR[:, None] * phi2
                + 2.0 * theta[None, :, None, None] * eye[:, :, None, None] * phi1)
    val_cols = val_cols.reshape(dim, dim * n1, n2)
    if not use_grad:
        return val_cols

    # d3 k / dx1_i dx1_k dx2_j, axes (k, i, j, n1, n2)
    Tk = thR[:, None, None]
    Ti = thR[None, :, None]
    Tj = thR[None, None, :]
    d_ij = eye[None, :, :, None, None]
    d_kj = eye[:, None, :, None, None]
    d_ik = eye[:, :, None, None, None]
    th = theta
    term_ij = -4.0 * d_ij * (th[None, :, None, None, None] * Tk) * phi2
    term_kj = -4.0 * d_kj * (th[:, None, None, None, None] * Ti) * phi2
    term_ik = -4.0 * d_ik * (th[:, None, None, None, None] * Tj) * phi2
    grad_cols = -8.0 * Ti * Tj * Tk * phi3 + term_ij + term_kj + term_ik
    if idx_g2 is not None:
        grad_cols = grad_cols[..., torch.as_tensor(idx_g2, device=R.device)]
    n2g = grad_cols.shape[-1]
    grad_cols = grad_cols.permute(0, 1, 3, 2, 4).reshape(dim, dim * n1, dim * n2g)
    return torch.cat([val_cols, grad_cols], dim=2)


def scalar_kernel(kernel_type: str, x1, x2, theta, alpha=None):
    """k(x1, x2) as a scalar function of two points (d,): the autograd
    oracle (``torch.func.grad`` / ``hessian``) that the closed-form blocks
    are held against, and the examples' kernel correlations."""
    r = x1 - x2
    phi, *_ = PHI[kernel_type](torch.sum(theta * r * r), alpha)
    return phi
