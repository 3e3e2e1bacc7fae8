"""Large-n marginal log-likelihood: matrix-free CG solves + stochastic
Lanczos log-determinant, with determinant-free hyperparameter gradients
(counterpart of ``gpgradpy_tpu/model/likelihood_iter.py``).

The covariance is never materialized; solves are preconditioned CG on the
symmetrically scaled system, and the gradients use the estimator
    d ln L / d theta = -1/2 [ n * d varK/d theta / varK + tr(K^-1 dK) ],
    d varK/d theta  = -alpha^T (dK/d theta) alpha / n,
    tr(K^-1 dK)    ~= mean_i u_i^T (dK/d theta) z_i,   u_i = K^-1 z_i,
with the quadratic forms differentiated by autograd through the matrix-free
matvec (alpha, u_i, z_i detached; beta and varK are profiled maximizers, so
their sensitivities vanish).  On a CUDA device that autograd pass is
``ops/iterative.KernMatvecFn``'s backward: K2 per row tile.

The probes ``z`` (n_full, n_probes) are an argument: the SLQ log-det and the
trace term use the same ones, as the JAX package draws both from one key.

Everything runs in the FULL blocked layout (n_eval * (1 + dim) rows) with
missing gradient rows masked to an identity block,
    Keta' = M Keta M + (I - M),   M = diag(mask),
so partial and absent gradients run the full gradient-enhanced matvec (and
K1/K2 on the card) as the JAX package does.

Two batchings differ from the JAX package in cost: an objective's solves
(GLS, the SLQ probes and, for the gradient, u = K^-1 z) run as one batched
CG (``_solve_all``), and the surrogate's two quadratic forms share one
matvec of the stacked columns [alpha | z].
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import GpConfig
from ..ops import iterative, kernels
from ..parallel import sharded_matvec
from ..types import DataSpec, GpData, Hypers
from . import assembly, likelihood, mean


def make_grad_mask(spec: DataSpec, dtype, device=None) -> Optional[torch.Tensor]:
    """(n_eval*(1+dim),) blocked-layout mask: 1 on value rows and on the
    gradient rows of points in spec.idx_grad, 0 elsewhere.  None in the
    full-gradient square case."""
    n = spec.n_eval
    if spec.use_grad and spec.n_grad == n:
        return None
    ind = np.zeros(n)
    if spec.use_grad:
        ind[list(spec.idx_grad)] = 1.0
    m = np.concatenate([np.ones(n), np.tile(ind, spec.dim)])
    return torch.as_tensor(m, dtype=dtype, device=device)


def expand_to_full(spec: DataSpec, M: torch.Tensor) -> torch.Tensor:
    """Compact blocked layout (n_eval + n_grad*dim[, m]) -> full blocked
    layout (n_eval*(1+dim)[, m]) with zero rows at missing gradients."""
    n, d, g = spec.n_eval, spec.dim, spec.n_grad
    if spec.use_grad and g == n:
        return M
    vec = M.ndim == 1
    M2 = M[:, None] if vec else M
    full = M2.new_zeros((d, n, M2.shape[1]))
    if g:
        idx = torch.as_tensor(np.asarray(spec.idx_grad), device=M.device)
        full[:, idx] = M2[n:].reshape(d, g, -1)
    out = torch.cat([M2[:n], full.reshape(d * n, -1)], dim=0)
    return out[:, 0] if vec else out


class IterPieces(NamedTuple):
    """Masked matrix-free building blocks shared by the MLL and predict
    paths, all in the working layout: the full blocked layout, or with a
    mesh its point-major permutation."""
    mv_hp: Callable            # (hp, V (N, m)[, extra]) -> Keta'(hp) V
    extra_hp: Callable         # hp -> the diagonal Keta adds to K (N,)
    diag_hp: Callable          # hp -> diag(Keta') (N,), 1 on masked rows
    data_vec: torch.Tensor     # (N,)  zero on masked rows
    vand: torch.Tensor         # (N, n_beta) zero rows at masked entries
    mask: Optional[torch.Tensor]  # (N,) or None; N = n_eval * (1 + dim)


def _iter_setup(cfg: GpConfig, spec: DataSpec, data: GpData,
                eta_const: float, row_block: int, mesh=None) -> IterPieces:
    """With ``mesh`` (a ``parallel.mesh.Mesh``, whose size divides n_eval)
    the matvec splits its rows over the ranks
    (``sharded_matvec.kern_matvec_sharded_batch``) and every vector is in
    the point-major layout, as in the JAX package (likelihood_iter.py:90-140
    there); the CG vectors stay whole on every rank."""
    if spec.n_pad_eval:
        raise ValueError("iterative path: disable shape-bucket padding "
                         "(pad_n_eval_multiple)")
    dtype, dev = data.x.dtype, data.x.device
    n, dim = spec.n_eval, spec.dim
    n_full = n * (1 + dim)
    noisy = spec.b_has_noisy_data
    mask_b = make_grad_mask(spec, dtype, dev)
    if mesh is not None:
        def conv(v):
            return sharded_matvec.blocked_to_pm_mat(v, n, dim)
    else:
        def conv(v):
            return v

    def base_diag(hp_):
        """diag(K): value rows 1, gradient rows gamma_a^2."""
        gamma2 = kernels.theta2gamma(cfg.kernel_type, hp_.theta) ** 2
        return torch.cat([torch.ones(n, dtype=dtype, device=dev),
                          gamma2.to(dtype).repeat_interleave(n)])

    def extra_diag(hp_):
        """Diagonal added to K: noise/varK plus eta P^2 (P = I under 'base';
        P^2 = diag(K + noise/varK) under 'precon').  Differentiable."""
        if noisy:
            nv = expand_to_full(
                spec, assembly.calc_noise_vec(spec, data, hp_).to(dtype)
                / hp_.varK)
        else:
            nv = torch.zeros(n_full, dtype=dtype, device=dev)
        if cfg.wellcond_mtd == "precon":
            return conv(nv + eta_const * (base_diag(hp_) + nv))
        return conv(nv + eta_const)

    mask = None if mask_b is None else conv(mask_b)
    unmask = None if mask is None else (1.0 - mask)[:, None]

    def mv_hp(hp_, V, extra=None):
        """Keta'(hp_) V; ``extra`` = extra_diag(hp_) where the caller holds
        it already (a solve at fixed hp)."""
        Vm = V if mask is None else mask[:, None] * V
        extra = extra_diag(hp_) if extra is None else extra
        if mesh is not None:
            out = sharded_matvec.kern_matvec_sharded_batch(
                cfg.kernel_type, mesh, data.x, hp_.theta, hp_.kernel, Vm,
                eta=1.0, pvec2_pm=extra, row_block=row_block)
        else:
            out = iterative.kern_matvec(
                cfg.kernel_type, data.x, hp_.theta, hp_.kernel, Vm,
                row_block=row_block, noise_over_varK=extra)
        if mask is not None:
            out = torch.addcmul(mask[:, None] * out, unmask, V)
        return out

    def diag_hp(hp_):
        d = conv(base_diag(hp_)) + extra_diag(hp_)
        if mask is not None:
            d = torch.where(mask > 0, d, torch.ones_like(d))
        return d

    data_vec = conv(expand_to_full(spec, likelihood.make_data_vec(spec, data)))
    vand = conv(expand_to_full(spec, mean.calc_aug_vand(
        cfg.mean_fun_type, data.x, spec.use_grad, spec.idx_grad_arr)))
    return IterPieces(mv_hp=mv_hp, extra_hp=extra_diag, diag_hp=diag_hp,
                      data_vec=data_vec, vand=vand, mask=mask)


def _detached(hp: Hypers) -> Hypers:
    return Hypers(*(None if t is None else t.detach() for t in hp))


def _solver(pieces: IterPieces, hp: Hypers, max_cg_iters: int,
            cg_tol: float):
    """CG solve closure on the symmetrically scaled system at fixed hp;
    returns (solve, diag).  The solves carry no autograd graph."""
    hp = _detached(hp)
    with torch.no_grad():
        diag = pieces.diag_hp(hp)
        extra = pieces.extra_hp(hp)
    d_isqrt = (1.0 / torch.sqrt(diag))[:, None]

    def mv_hat(V):
        return d_isqrt * pieces.mv_hp(hp, d_isqrt * V, extra)

    def solve(B):
        with torch.no_grad():
            res = iterative.mbcg(mv_hat, d_isqrt * B, max_iters=max_cg_iters,
                                 tol=cg_tol)
            return d_isqrt * res.X, res

    return solve, diag


def _gls(pieces: IterPieces, solve, beta_known=None):
    """GLS beta + residual solve in one batched CG: returns
    (beta, r, alpha = Keta'^-1 r, res)."""
    data_vec, vand = pieces.data_vec, pieces.vand
    if beta_known is not None:
        r = data_vec - vand @ beta_known
        sols, res = solve(r[:, None])
        return beta_known, r, sols[:, 0], res
    sols, res = solve(torch.cat([data_vec[:, None], vand], dim=1))
    return (*_gls_from(pieces, sols[:, 0], sols[:, 1:]), res)


def _gls_from(pieces: IterPieces, invK_y, invK_V):
    """(beta, r, alpha) from the solves of the data and of the Vandermonde
    columns."""
    data_vec, vand = pieces.data_vec, pieces.vand
    beta = mean._spd_solve(vand.T @ invK_V, invK_V.T @ data_vec)
    r = data_vec - vand @ beta
    return beta, r, invK_y - invK_V @ beta


class IterLkdInfo(NamedTuple):
    ln_lkd: torch.Tensor
    beta: torch.Tensor
    varK: torch.Tensor
    ln_det: torch.Tensor
    cg_resid: torch.Tensor
    cg_iters: torch.Tensor


class _Solved(NamedTuple):
    pieces: IterPieces
    beta: torch.Tensor
    r: torch.Tensor
    alpha: torch.Tensor          # Keta'^-1 r
    ln_det: torch.Tensor         # SLQ estimate of ln det Keta'
    u: Optional[torch.Tensor]    # Keta'^-1 z, where asked for
    cg_resid: torch.Tensor       # of the GLS columns, as the JAX info's
    cg_iters: torch.Tensor


def _solve_all(cfg, spec, data, hp, eta_const, z, max_cg_iters, cg_tol,
               row_block, with_u, mesh=None) -> _Solved:
    """Every solve an objective needs at fixed hp, as ONE batched CG on the
    scaled operator D^-1/2 Keta' D^-1/2 (D = diag Keta') with the columns
    [D^-1/2 y, D^-1/2 V] (GLS, to cg_tol), z (SLQ, to SLQ_CG_TOL) and, with
    ``with_u``, D^-1/2 z (u = Keta'^-1 z, to cg_tol).  The columns are
    independent (each converges and freezes at the iteration it would
    alone), so each comes out as from its own solve in the JAX package,
    which runs them as separate loops.  One difference in value: the
    gradient's alpha is the GLS one, where the JAX package solves r again;
    the two agree to the CG tolerance."""
    pieces = _iter_setup(cfg, spec, data, eta_const, row_block, mesh)
    hp = _detached(hp)
    with torch.no_grad():
        diag = pieces.diag_hp(hp)
        extra = pieces.extra_hp(hp)
        d_isqrt = (1.0 / torch.sqrt(diag))[:, None]
        gls = torch.cat([pieces.data_vec[:, None], pieces.vand], dim=1)
        n_gls, m = gls.shape[1], z.shape[1]
        cols = [d_isqrt * gls, z] + ([d_isqrt * z] if with_u else [])
        tol = torch.cat([
            torch.full((n_gls,), cg_tol, dtype=z.dtype, device=z.device),
            torch.full((m,), iterative.SLQ_CG_TOL, dtype=z.dtype,
                       device=z.device),
            torch.full((m if with_u else 0,), cg_tol, dtype=z.dtype,
                       device=z.device)])
        res = iterative.mbcg(
            lambda V: d_isqrt * pieces.mv_hp(hp, d_isqrt * V, extra),
            torch.cat(cols, dim=1), max_iters=max_cg_iters, tol=tol)
        X = d_isqrt * res.X
        beta, r, alpha = _gls_from(pieces, X[:, 0], X[:, 1:n_gls])
        probes = slice(n_gls, n_gls + m)
        ln_det = (iterative.slq_quadrature(res.alphas[:, probes],
                                           res.betas[:, probes], z.shape[0])
                  + torch.sum(torch.log(diag)))
    return _Solved(pieces=pieces, beta=beta, r=r, alpha=alpha, ln_det=ln_det,
                   u=X[:, n_gls + m:] if with_u else None,
                   cg_resid=torch.max(res.residnorm[:n_gls]),
                   cg_iters=iterative.iters_run(res.alphas[:, :n_gls]))


def calc_lkd_iterative(cfg: GpConfig, spec: DataSpec, data: GpData,
                       hp: Hypers, eta_const: float, z: torch.Tensor,
                       max_cg_iters: int = 256, cg_tol: float = 1e-10,
                       row_block: int = 256, mesh=None) -> IterLkdInfo:
    """Noise-free MLL via CG + SLQ with the probes z (n_full, n_probes) in
    the working layout (point-major with a mesh).  Full, partial or no
    gradients; 'precon' or 'base' with constant eta.  With ``mesh`` the
    matvec's rows are split over its ranks (``_iter_setup``)."""
    if spec.b_has_noisy_data:
        raise ValueError("noisy data: use calc_lkd_iterative_noisy")
    return _lkd_info(cfg, spec, _solve_all(
        cfg, spec, data, hp, eta_const, z, max_cg_iters, cg_tol, row_block,
        with_u=False, mesh=mesh))


def _lkd_info(cfg, spec, sol: _Solved) -> IterLkdInfo:
    n_data = spec.n_data
    varK = torch.clamp_min(torch.dot(sol.r, sol.alpha) / n_data,
                           cfg.varK_min)
    ln_lkd = -(n_data * torch.log(varK) + sol.ln_det) / 2.0
    return IterLkdInfo(ln_lkd=ln_lkd, beta=sol.beta, varK=varK,
                       ln_det=sol.ln_det, cg_resid=sol.cg_resid,
                       cg_iters=sol.cg_iters)


def neg_mll_iterative_and_grad(cfg: GpConfig, spec: DataSpec, data: GpData,
                               hp: Hypers, eta_const: float, z: torch.Tensor,
                               max_cg_iters: int = 256, cg_tol: float = 1e-10,
                               row_block: int = 256, mesh=None):
    """(-ln L, d(-ln L)/d theta, IterLkdInfo) with determinant-free
    gradients: the surrogate's quadratic forms are differentiated by
    autograd through the matrix-free matvec (alpha, u, z constant).  With
    ``mesh`` every rank gets the whole gradient (``ShardedMatvecFn``)."""
    if spec.b_has_noisy_data:
        raise ValueError("noisy data: use neg_mll_iterative_noisy_and_grad")
    sol = _solve_all(cfg, spec, data, hp, eta_const, z, max_cg_iters, cg_tol,
                     row_block, with_u=True, mesh=mesh)
    info = _lkd_info(cfg, spec, sol)
    alpha, u = sol.alpha, sol.u

    theta_ = hp.theta.detach().requires_grad_(True)
    with torch.enable_grad():
        out = sol.pieces.mv_hp(_detached(hp)._replace(theta=theta_),
                               torch.cat([alpha[:, None], z], dim=1))
        # d/dtheta [alpha^T K alpha] and d/dtheta [mean_i u_i^T K z_i]
        # ~= tr(K^-1 dK); the masked identity block drops out
        quad_alpha = torch.dot(alpha, out[:, 0])
        trace_term = torch.mean(torch.sum(u * out[:, 1:], dim=0))
        surrogate = 0.5 * (-quad_alpha / info.varK + trace_term)
        grad_theta, = torch.autograd.grad(surrogate, theta_)
    return -info.ln_lkd, grad_theta, info


# ---------------------------------------------------------------------------
# Noisy regime (varK and the noise variances as numeric hyperparameters)
# ---------------------------------------------------------------------------

def calc_lkd_iterative_noisy(cfg: GpConfig, spec: DataSpec, data: GpData,
                             hp: Hypers, eta_const: float, z: torch.Tensor,
                             max_cg_iters: int = 256, cg_tol: float = 1e-10,
                             row_block: int = 256,
                             mesh=None) -> IterLkdInfo:
    """Noisy-regime MLL via CG + SLQ:
    -2 ln L = n ln varK + ln det Keta + r^T Keta^-1 r / varK."""
    if not spec.b_has_noisy_data:
        raise ValueError("noise-free data: use calc_lkd_iterative")
    return _lkd_info_noisy(spec, hp, _solve_all(
        cfg, spec, data, hp, eta_const, z, max_cg_iters, cg_tol, row_block,
        with_u=False, mesh=mesh))


def _lkd_info_noisy(spec, hp, sol: _Solved) -> IterLkdInfo:
    varK = hp.varK.detach()
    quad = torch.dot(sol.r, sol.alpha) / varK
    ln_det_Kcov = spec.n_data * torch.log(varK) + sol.ln_det
    return IterLkdInfo(ln_lkd=-(ln_det_Kcov + quad) / 2.0, beta=sol.beta,
                       varK=varK, ln_det=ln_det_Kcov, cg_resid=sol.cg_resid,
                       cg_iters=sol.cg_iters)


_NOISY_LEAVES = ("theta", "varK", "var_fval", "var_fgrad")


def neg_mll_iterative_noisy_and_grad(cfg: GpConfig, spec: DataSpec,
                                     data: GpData, hp: Hypers,
                                     eta_const: float, z: torch.Tensor,
                                     max_cg_iters: int = 256,
                                     cg_tol: float = 1e-10,
                                     row_block: int = 256, mesh=None):
    """(-ln L, Hypers of gradients over theta, varK, var_fval and var_fgrad
    (those hp carries), info) for the noisy regime, determinant-free:

      d(-lnL)/dhp = 1/2 [ n dln varK + tr(Keta^-1 dKeta)
                          + d( r^T Keta^-1 r / varK ) ],

    with the trace by Hutchinson (u = Keta^-1 z) and the quadratic term by
    the exact surrogate (2 a^T r - a^T Keta(hp) a)/varK(hp) at
    a = Keta^-1 r (detached)."""
    n_data = spec.n_data
    if not spec.b_has_noisy_data:
        raise ValueError("noise-free data: use neg_mll_iterative_and_grad")
    sol = _solve_all(cfg, spec, data, hp, eta_const, z, max_cg_iters, cg_tol,
                     row_block, with_u=True, mesh=mesh)
    info = _lkd_info_noisy(spec, hp, sol)
    a, u = sol.alpha, sol.u
    ar = torch.dot(a, sol.r)

    names = [f for f in _NOISY_LEAVES if getattr(hp, f) is not None]
    leaves = {f: getattr(hp, f).detach().requires_grad_(True) for f in names}
    with torch.enable_grad():
        hp_ = _detached(hp)._replace(**leaves)
        out = sol.pieces.mv_hp(hp_, torch.cat([a[:, None], z], dim=1))
        trace_term = torch.mean(torch.sum(u * out[:, 1:], dim=0))
        quad_surr = (2.0 * ar - torch.dot(a, out[:, 0])) / hp_.varK
        surrogate = 0.5 * (n_data * torch.log(hp_.varK) + trace_term
                           + quad_surr)
        grads = torch.autograd.grad(surrogate, list(leaves.values()),
                                    allow_unused=True)
    grad_hp = Hypers(**{f: torch.zeros_like(leaves[f]) if g is None else g
                        for f, g in zip(names, grads)})
    return -info.ln_lkd, grad_hp, info


# ---------------------------------------------------------------------------
# Closed-form beta/varK through CG (facade hook, no SLQ)
# ---------------------------------------------------------------------------

def closed_form_iterative(cfg: GpConfig, spec: DataSpec, data: GpData,
                          hp: Hypers, eta_const: float,
                          max_cg_iters: int = 256, cg_tol: float = 1e-10,
                          row_block: int = 256, mesh=None) -> Hypers:
    """Fill in beta (and varK in the noise-free regime) with their GLS /
    profiled maximizers via batched CG."""
    pieces = _iter_setup(cfg, spec, data, eta_const, row_block, mesh)
    solve, _ = _solver(pieces, hp, max_cg_iters, cg_tol)
    beta, r, alpha, _ = _gls(pieces, solve)
    if spec.b_has_noisy_data:
        varK = hp.varK
    else:
        varK = torch.clamp_min(torch.dot(r, alpha) / spec.n_data,
                               cfg.varK_min)
    return hp._replace(beta=beta, varK=varK)
