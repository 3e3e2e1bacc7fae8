"""Dense linear algebra for the GP core: Cholesky with a success flag,
Cholesky solves, log-determinant and differentiable condition numbers
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


class CholDistFn(torch.autograd.Function):
    """The distributed blocked Cholesky (``parallel/chol_dist.py``), its
    factor gathered to every rank, with the closed-form pullback on the
    saved factor (linalg.py:72-114 of the JAX package):

        Abar = L^-T Phi(L^T Lbar) L^-1,  Phi = tril, diagonal halved,

    returned symmetrized.  A and Lbar are the same on every rank, so each
    rank computes the whole Abar with two triangular solves and no
    collective."""

    @staticmethod
    def forward(ctx, A, mesh, block: int):
        from ..parallel.chol_dist import cholesky_dist
        from ..parallel.mesh import gather_batch
        L_loc, _ = cholesky_dist(mesh, A, block)
        L = gather_batch(L_loc, mesh)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        L, = ctx.saved_tensors
        W = torch.tril(L.T @ Lbar)
        W = W - 0.5 * torch.diag_embed(torch.diagonal(W))
        Y = torch.linalg.solve_triangular(L.T, W, upper=True)   # L^T Y = Phi
        Abar = torch.linalg.solve_triangular(L, Y, upper=False,
                                             left=False)        # Y L^-1
        return 0.5 * (Abar + Abar.T), None, None


def cholesky_ok_dist(A: torch.Tensor, mesh, block: int = 64) -> CholFac:
    """``cholesky_ok`` of one (n, n) matrix with the factorization
    distributed over the ranks of ``mesh`` (linalg.py:117-132 of the JAX
    package): the factor, gathered, with the identity in place of a failed
    one and the ``ok`` flag, the same on every rank; differentiable.

    The pullback is the symmetrized one, which is right where A is built
    elementwise-symmetrically from what is differentiated (every
    covariance here is); for an asymmetric construction use
    ``cholesky_ok``."""
    L = CholDistFn.apply(A, mesh, int(block))
    d = torch.diagonal(L)
    ok = torch.isfinite(d).all() & (d > 0.0).all()
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return CholFac(torch.where(ok, L, eye), ok)


def cho_solve(fac: CholFac, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for a right-hand side matrix b of shape (..., n, k)."""
    return torch.cholesky_solve(b, fac.L)


def refine_solve(fac: CholFac, M: torch.Tensor, b: torch.Tensor,
                 n_iter: int) -> torch.Tensor:
    """Mixed-precision iterative refinement of ``M x = b`` (b (..., n, k)).

    ``fac`` is a lower-precision (f32) Cholesky factor of ``M``; the
    residuals ``r = b - M x`` are taken in the precision of M and b (f64)
    with a plain ``torch.matmul``, and each correction is a low-precision
    solve.  Each iteration shrinks the error by ~cond(M) eps_f32, so at
    cond(M) <= ~1e6 two iterations reach ~eps_f64 while the O(n^3)
    factorization stays in f32 (linalg.py:51-68 of the JAX package)."""
    lo = fac.L.dtype
    hi = torch.promote_types(M.dtype, b.dtype)
    x = cho_solve(fac, b.to(lo)).to(hi)
    for _ in range(int(n_iter)):
        r = b - M @ x
        x = x + cho_solve(fac, r.to(lo)).to(hi)
    return x


def logdet_from_chol(fac: CholFac) -> torch.Tensor:
    """log det A = 2 sum log diag(L)."""
    return 2.0 * torch.log(torch.diagonal(fac.L, dim1=-2, dim2=-1)).sum(-1)


class CondEigh(torch.autograd.Function):
    """Spectral condition number w_max / max(w_min, tiny) of a symmetric
    matrix (..., n, n), with the closed-form rank-1 backward of the JAX
    package's custom VJP (linalg.py:135-174 there):

        d cond / dA = v_max v_max^T / w_min
                      - active * w_max / w_min^2 * v_min v_min^T,

    where ``active`` zeroes the second term where w_min is clamped at tiny
    (the value is locally constant in it).  The JAX package multiplies by
    ``active`` and gets NaN there (tiny^2 underflows, 0 * inf); the port
    selects the zero.  The forward takes eigenvectors only when a gradient
    is asked for.

    ``torch.linalg.eigh`` raises on a non-finite matrix where
    ``jnp.linalg.eigh`` returns NaN; a batch row that is not finite gets the
    JAX outcome (NaN condition number, NaN gradient) without its matrix
    reaching eigh (the identity takes its place there)."""

    @staticmethod
    def forward(ctx, A):
        finite = torch.isfinite(A).all(-1).all(-1)
        eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
        A_safe = torch.where(finite[..., None, None], A, eye)
        if ctx.needs_input_grad[0]:
            w, V = torch.linalg.eigh(A_safe)
        else:
            w, V = torch.linalg.eigvalsh(A_safe), None
        w = torch.where(finite[..., None], w, float("nan"))
        ctx.save_for_backward(w, V)
        tiny = torch.finfo(A.dtype).tiny
        return w[..., -1] / torch.clamp_min(w[..., 0], tiny)

    @staticmethod
    def backward(ctx, g):
        w, V = ctx.saved_tensors
        tiny = torch.finfo(w.dtype).tiny
        w_lo, w_hi = w[..., 0], w[..., -1]
        w_min = torch.clamp_min(w_lo, tiny)
        v_min, v_max = V[..., :, 0], V[..., :, -1]
        c_max = (g / w_min)[..., None, None]
        # where w_min is clamped, tiny^2 underflows to 0: select the zero
        # rather than multiply it in (0 * inf is NaN)
        c_min = torch.where(w_lo > tiny, g * w_hi / (w_min * w_min),
                            torch.zeros_like(g))[..., None, None]
        return (c_max * (v_max[..., :, None] * v_max[..., None, :])
                - c_min * (v_min[..., :, None] * v_min[..., None, :]))


def cond_eigh(A: torch.Tensor) -> torch.Tensor:
    """Spectral condition number of a symmetric matrix (..., n, n),
    differentiable (``CondEigh``)."""
    return CondEigh.apply(A)


def cond_fro_w_chol(A: torch.Tensor, fac: CholFac) -> torch.Tensor:
    """Frobenius-norm condition number ||A||_F ||A^-1||_F; autograd
    differentiates it through the Cholesky solves.  A row whose Cholesky
    failed has the identity as its factor and gets ||A||_F sqrt(n), as in
    the JAX package.  A factor taken in a lower precision than A (the
    refined predict's f32 factor of an f64 M) is promoted to A's, as the
    JAX package's triangular solve promotes it."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A_inv = cho_solve(fac._replace(L=fac.L.to(A.dtype)), eye.expand_as(A))
    return (torch.linalg.matrix_norm(A, "fro")
            * torch.linalg.matrix_norm(A_inv, "fro"))
