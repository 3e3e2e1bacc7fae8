"""Large-n posterior prediction without materializing the training
covariance (counterpart of ``gpgradpy_tpu/model/predict_iter.py``): solves
by batched CG against the matrix-free Keta matvec (K1 per row tile on the
card), the cross-covariance in plain PyTorch as ``model/predict.py`` builds
it.  Noise-free and noisy regimes, full / partial / no gradients (the
masked full layout of ``likelihood_iter``).  No probes: deterministic.

With ``mesh`` the training points are split over its ranks: the matvec's
rows (``likelihood_iter._iter_setup``) and the cross covariance's (each
rank's points against the queries, K1's value columns, gathered), in the
point-major layout; mu and sigma only, as in the JAX package."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GpConfig
from ..ops import kernels, rtensor
from ..parallel import sharded_matvec
from ..types import DataSpec, GpData, Hypers
from . import mean
from .likelihood_iter import _gls, _iter_setup, _solver


def _cross_cov_full(cfg: GpConfig, spec: DataSpec, x_train: torch.Tensor,
                    xq: torch.Tensor, hp: Hypers, calc_grad: bool = False,
                    mesh=None):
    """Cross covariance in the FULL blocked layout: Kyx (n*(1+d), nx) and,
    with ``calc_grad``, dKxy_dx (nx*d, n*(1+d)) ordered b*nx + q.  Masking
    of missing gradient rows is the caller's job.  With ``mesh``: Kyx in
    the point-major layout, split over the ranks (no dKxy_dx)."""
    if mesh is not None:
        if calc_grad:
            raise NotImplementedError(
                "sharded cross covariance: mu and sigma only (as in the JAX "
                "package)")
        return sharded_matvec.cross_cov_sharded(
            cfg.kernel_type, mesh, x_train, xq, hp.theta, hp.kernel), None
    dim = x_train.shape[1]
    nx, n = xq.shape[0], x_train.shape[0]
    G = kernels.kern_block_tensor(cfg.kernel_type,
                                  rtensor.calc_rtensor(x_train, xq),
                                  hp.theta, hp.kernel)
    Kyx = G[:, 0].reshape((1 + dim) * n, nx)
    dKxy_dx = None
    if calc_grad:
        dKxy_dx = torch.cat([G[:, b].reshape((1 + dim) * n, nx).T
                             for b in range(1, dim + 1)], dim=0)
    return Kyx, dKxy_dx


class IterEvalState(NamedTuple):
    """Serving state of the iterative predict path: the residual solve is
    done once at setup; each eval solves only for the query columns."""
    hp: Hypers                 # with beta/varK filled in
    alpha: torch.Tensor        # Keta'^-1 (y - V beta)
    cg_resid: torch.Tensor
    cg_iters: torch.Tensor


def setup_eval_iterative(cfg: GpConfig, spec: DataSpec, data: GpData,
                         hp: Hypers, eta_const: float,
                         max_cg_iters: int = 256, cg_tol: float = 1e-10,
                         row_block: int = 256, mesh=None) -> IterEvalState:
    """Matrix-free analog of predict.setup_eval: one batched CG for the
    residual solve (and the GLS beta/varK if hp does not carry them)."""
    pieces = _iter_setup(cfg, spec, data, eta_const, row_block, mesh)
    solve, _ = _solver(pieces, hp, max_cg_iters, cg_tol)
    beta, r, alpha, res = _gls(pieces, solve, beta_known=hp.beta)
    varK = hp.varK
    if varK is None:
        if spec.b_has_noisy_data:
            raise ValueError("noisy data: varK is a hyperparameter")
        varK = torch.clamp_min(torch.dot(r, alpha) / spec.n_data,
                               cfg.varK_min)
    return IterEvalState(hp=hp._replace(beta=beta, varK=varK), alpha=alpha,
                         cg_resid=torch.max(res.residnorm),
                         cg_iters=res.n_iter)


def eval_model_iterative(cfg: GpConfig, spec: DataSpec, data: GpData,
                         state: IterEvalState, eta_const: float,
                         xq: torch.Tensor, calc_sig: bool = True,
                         calc_grad: bool = False, max_cg_iters: int = 256,
                         cg_tol: float = 1e-10, row_block: int = 256,
                         mesh=None):
    """(mu, sig, dmudx, dsigdx) at query points xq (nx, dim).  sig costs one
    batched CG over the nx cross-covariance columns; mu alone only the
    cross-covariance against the cached alpha."""
    hp = state.hp
    nx, dim = xq.shape
    pieces = _iter_setup(cfg, spec, data, eta_const, row_block, mesh)
    Kyx, dKxy_dx = _cross_cov_full(cfg, spec, data.x, xq, hp,
                                   calc_grad=calc_grad, mesh=mesh)
    if pieces.mask is not None:
        Kyx = Kyx * pieces.mask[:, None]
        if dKxy_dx is not None:
            dKxy_dx = dKxy_dx * pieces.mask[None, :]

    mval, mgrad, _ = mean.eval_mean_fun(cfg.mean_fun_type, xq, hp.beta)
    mu = mval + Kyx.T @ state.alpha
    varK = hp.varK
    sig = dmudx = dsigdx = None
    if calc_grad:
        dmudx = (dKxy_dx @ state.alpha).reshape(dim, nx).T + mgrad
    if calc_sig:
        solve, _ = _solver(pieces, hp, max_cg_iters, cg_tol)
        invK_Kyx, _ = solve(Kyx)
        sig2_wo = torch.clamp_min(1.0 - torch.sum(Kyx * invK_Kyx, dim=0), 0.0)
        sig = torch.sqrt(sig2_wo) * torch.sqrt(varK)
        if calc_grad:
            # d sig/dx = -varK (dKxy . Keta^-1 Kyx) / sig  (predict.py)
            term2 = torch.sum(dKxy_dx * invK_Kyx.T.repeat(dim, 1), dim=1)
            pos = sig > 0
            inv_sig = torch.where(
                pos, 1.0 / torch.where(pos, sig, torch.ones_like(sig)),
                torch.zeros_like(sig))
            dsigdx = -(inv_sig[:, None]) * term2.reshape(dim, nx).T * varK
    return mu, sig, dmudx, dsigdx


def predict_iterative(cfg: GpConfig, spec: DataSpec, data: GpData,
                      hp: Hypers, eta_const: float, xq: torch.Tensor,
                      max_cg_iters: int = 256, cg_tol: float = 1e-10,
                      row_block: int = 256, calc_sig: bool = True,
                      mesh=None):
    """One-shot posterior (mu, sig, beta, varK, res) at xq: the GLS and the
    query solves batch into one mbcg call."""
    pieces = _iter_setup(cfg, spec, data, eta_const, row_block, mesh)
    solve, _ = _solver(pieces, hp, max_cg_iters, cg_tol)
    Kyx, _ = _cross_cov_full(cfg, spec, data.x, xq, hp, mesh=mesh)
    if pieces.mask is not None:
        Kyx = Kyx * pieces.mask[:, None]

    data_vec, vand = pieces.data_vec, pieces.vand
    nb = vand.shape[1]
    sols, res = solve(torch.cat([data_vec[:, None], vand,
                                 Kyx if calc_sig else Kyx[:, :0]], dim=1))
    invK_y, invK_V = sols[:, 0], sols[:, 1:1 + nb]
    beta = mean._spd_solve(vand.T @ invK_V, invK_V.T @ data_vec)
    r = data_vec - vand @ beta
    alpha = invK_y - invK_V @ beta
    if spec.b_has_noisy_data:
        varK = hp.varK
    else:
        varK = torch.clamp_min(torch.dot(r, alpha) / spec.n_data,
                               cfg.varK_min)
    mval, _, _ = mean.eval_mean_fun(cfg.mean_fun_type, xq, beta)
    mu = mval + Kyx.T @ alpha
    sig = None
    if calc_sig:
        sig2_wo = 1.0 - torch.sum(Kyx * sols[:, 1 + nb:], dim=0)
        sig = torch.sqrt(torch.clamp_min(sig2_wo, 0.0) * varK)
    return mu, sig, beta, varK, res
