"""Dense linear algebra for the GP core: Cholesky with a success flag,
Cholesky solves, log-determinant and condition numbers
(counterpart of ``gpgradpy_tpu/ops/linalg.py``).

Every function takes an optional leading batch of matrices.  The
factorizations go to ``torch.linalg`` (LAPACK on the CPU, cuSOLVER on the
card).  ``torch.linalg.cholesky`` raises on a matrix that is not positive
definite, so ``cholesky_ok`` uses ``cholesky_ex`` and reads its ``info``:
each failed batch row gets the identity as its factor and ``ok`` False, so
that downstream solves stay finite and the caller can switch that row to its
fallback objective, as the JAX package does with its NaN-returning Cholesky.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CholFac(NamedTuple):
    """Lower-triangular Cholesky factor with a per-row validity flag."""
    L: torch.Tensor     # (..., n, n)
    ok: torch.Tensor    # (...,) bool


def cholesky_ok(A: torch.Tensor) -> CholFac:
    L, info = torch.linalg.cholesky_ex(A)
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = (info == 0) & torch.isfinite(d).all(-1) & (d > 0.0).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L = torch.where(ok[..., None, None], L, eye)
    return CholFac(L, ok)


def cho_solve(fac: CholFac, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for a right-hand side matrix b of shape (..., n, k)."""
    return torch.cholesky_solve(b, fac.L)


def logdet_from_chol(fac: CholFac) -> torch.Tensor:
    """log det A = 2 sum log diag(L)."""
    return 2.0 * torch.log(torch.diagonal(fac.L, dim1=-2, dim2=-1)).sum(-1)


def cond_eigh(A: torch.Tensor) -> torch.Tensor:
    """Spectral condition number of a symmetric matrix (telemetry only: no
    gradient is taken through it on the ported path; its closed-form rank-1
    backward comes with the constrained SLSQP fit)."""
    with torch.no_grad():
        w = torch.linalg.eigvalsh(A)
        w_min = torch.clamp_min(w[..., 0], torch.finfo(A.dtype).tiny)
        return w[..., -1] / w_min


def cond_fro_w_chol(A: torch.Tensor, fac: CholFac) -> torch.Tensor:
    """Frobenius-norm condition number ||A||_F ||A^-1||_F."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A_inv = cho_solve(fac, eye.expand_as(A))
    return (torch.linalg.matrix_norm(A, "fro")
            * torch.linalg.matrix_norm(A_inv, "fro"))
