"""Posterior prediction: mean, standard deviation and their first and
second derivatives at query points (counterpart of
``gpgradpy_tpu/model/predict.py``), for one hyperparameter row.

Precision: the predict runs in ``_predict_dtype(cfg)``.  With
``cfg.dtype == 'float64'`` f32 inputs are promoted (the polish mode, whose
main fit ran in f32); with ``cfg.n_refine_predict`` the covariance is
assembled in f64 and factorized in f32, and every predict solve refines
against the f64 matrix (``_ops_solve``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GpConfig
from ..ops import kernels, linalg, rtensor
from ..types import DataSpec, GpData, Hypers, cast_float_tree
from . import assembly, likelihood, mean


class EvalState(NamedTuple):
    """Cached quantities for surrogate evaluation."""
    ops: assembly.KetaOps       # varK-normalized factorization
    invK_fdiff: torch.Tensor    # Keta^-1 (y - m)
    hp: Hypers                  # with beta and varK filled in
    cond: torch.Tensor


def _predict_dtype(cfg: GpConfig) -> torch.dtype:
    """f64 when the config says so or when the refined predict is on."""
    if cfg.dtype == "float64" or cfg.n_refine_predict:
        return torch.float64
    return torch.float32


def _ops_solve(cfg: GpConfig, ops: assembly.KetaOps,
               b: torch.Tensor) -> torch.Tensor:
    """Keta^-1 b for b (n,) or (n, k); with iterative refinement against
    the full-precision M when the factor was taken in a lower precision
    (cfg.n_refine_predict > 0)."""
    if cfg.n_refine_predict and ops.fac.L.dtype != ops.M.dtype:
        vec = b.ndim == ops.pvec.ndim
        rhs = b[..., None] if vec else b
        p = ops.pvec[..., :, None]
        y = linalg.refine_solve(ops.fac, ops.M, rhs / p,
                                cfg.n_refine_predict) / p
        return y[..., 0] if vec else y
    return ops.solve(b)


def setup_eval(cfg: GpConfig, spec: DataSpec, data: GpData, hp: Hypers,
               eta_const: float, calc_cond: bool = False) -> EvalState:
    """Factorize the varK-normalized covariance and cache Keta^-1 (y - m),
    in the predict precision (the module note)."""
    dt = _predict_dtype(cfg)
    data, hp = cast_float_tree(data, dt), cast_float_tree(hp, dt)
    ops = assembly.assemble_keta(
        cfg, spec, data, hp, eta_const,
        varK=hp.varK if spec.b_has_noisy_data else None,
        factor_dtype=torch.float32 if cfg.n_refine_predict else None)
    data_vec = likelihood.make_data_vec(spec, data)
    vand = mean.calc_aug_vand(cfg.mean_fun_type, data.x, spec.use_grad,
                              spec.idx_grad_arr)
    pad_mask = spec.pad_mask()
    if pad_mask is not None:
        mv = torch.as_tensor(pad_mask, dtype=vand.dtype, device=vand.device)
        vand = vand * mv[:, None]
        data_vec = data_vec * mv
    invK_fdiff = _ops_solve(cfg, ops, data_vec - vand @ hp.beta)
    cond = (assembly.calc_cond(ops, cfg.cond_norm) if calc_cond
            else torch.tensor(float("nan")))
    return EvalState(ops=ops, invK_fdiff=invK_fdiff, hp=hp, cond=cond)


def _cross_cov(cfg: GpConfig, spec: DataSpec, x_train, xq, hp: Hypers):
    """Kyx (n_data, nx) and dKxy_dx (nx*dim, n_data): cross covariance of the
    training data (values + used gradients) with the query points and with
    the query-point derivatives.  Plain PyTorch, as the JAX package leaves
    it to XLA (predict.py:81-93 there)."""
    R = rtensor.calc_rtensor(x_train, xq)
    G = kernels.kern_block_tensor(cfg.kernel_type, R, hp.theta, hp.kernel)
    dim = spec.dim
    idx = spec.idx_grad_arr
    if idx is not None:
        idx = torch.as_tensor(idx, device=xq.device)

    def rows(col_block):
        blk = G[:, col_block]              # (1+d, n_train, nx)
        parts = [blk[0]]
        if spec.use_grad:
            parts += [blk[a] if idx is None else blk[a][idx]
                      for a in range(1, dim + 1)]
        return torch.cat(parts, dim=0)     # (n_data, nx)

    Kyx = rows(0)
    dKxy_dx = torch.cat([rows(b).T for b in range(1, dim + 1)], dim=0)

    pad_mask = spec.pad_mask()
    if pad_mask is not None:
        mv = torch.as_tensor(pad_mask, dtype=Kyx.dtype, device=Kyx.device)
        Kyx = Kyx * mv[:, None]
        dKxy_dx = dKxy_dx * mv[None, :]
    return Kyx, dKxy_dx


def _hess_terms(cfg, spec, data, state, xq, Kxy_invK, dKxy_dx):
    """H (d, nx*d, n_data) and the d2(sig^2) term shared by eval_model and
    eval_model_var."""
    hp = state.hp
    nx, dim = xq.shape
    N = spec.n_data_tot
    Rq = rtensor.calc_rtensor(xq, data.x)
    H = kernels.kern_hess_x(cfg.kernel_type, Rq, hp.theta, hp.kernel,
                            use_grad=spec.use_grad, idx_g2=spec.idx_grad_arr)
    Ht = H.reshape(dim, dim, nx, N)
    term1 = torch.einsum("kiqm,qm->qki", Ht, Kxy_invK)
    solve_dK = _ops_solve(cfg, state.ops, dKxy_dx.T)       # (n_data, nx*d)
    D = dKxy_dx.reshape(dim, nx, N)
    S = solve_dK.T.reshape(dim, nx, N)
    term2h = torch.einsum("kqm,iqm->qki", D, S)
    return H, -2.0 * hp.varK * (term1 + term2h)


def eval_model(cfg: GpConfig, spec: DataSpec, data: GpData, state: EvalState,
               xq: torch.Tensor, calc_grad: bool = False,
               calc_hess: bool = False):
    """Returns (mu, sig, dmudx, dsigdx, d2mudx2, d2sigdx2) at the query
    points xq (nx, dim); derivative outputs are None unless requested."""
    hp = state.hp
    nx, dim = xq.shape
    dt = _predict_dtype(cfg)
    data, xq = cast_float_tree(data, dt), xq.to(dt)
    varK = hp.varK
    sigK = torch.sqrt(varK)

    Kyx, dKxy_dx = _cross_cov(cfg, spec, data.x, xq, hp)
    Kxy_invK = _ops_solve(cfg, state.ops, Kyx).T          # (nx, n_data)
    mval, mgrad, mhess = mean.eval_mean_fun(cfg.mean_fun_type, xq, hp.beta)

    mu = mval + Kyx.T @ state.invK_fdiff
    sig2_wo = torch.clamp_min(1.0 - torch.sum(Kyx.T * Kxy_invK, dim=1), 0.0)
    sig = torch.sqrt(sig2_wo) * sigK

    dmudx = dsigdx = d2mudx2 = d2sigdx2 = None
    if calc_grad:
        dmudx = (dKxy_dx @ state.invK_fdiff).reshape(dim, nx).T + mgrad
        term2 = torch.sum(dKxy_dx * Kxy_invK.repeat(dim, 1), dim=1)
        pos = sig > 0
        inv_sig = torch.where(pos, 1.0 / torch.where(pos, sig, torch.ones_like(sig)),
                              torch.zeros_like(sig))
        dsigdx = -(inv_sig[:, None]) * term2.reshape(dim, nx).T * varK

    if calc_hess:
        if dsigdx is None:
            raise ValueError("calc_hess requires calc_grad")
        H, d2sig2 = _hess_terms(cfg, spec, data, state, xq, Kxy_invK, dKxy_dx)
        Hv = H @ state.invK_fdiff                          # (d, nx*d)
        d2mudx2 = Hv.reshape(dim, dim, nx).permute(2, 0, 1) + mhess
        sig_mod = torch.where(sig == 0, torch.full_like(sig, float("nan")), sig)
        outer = dsigdx[:, :, None] * dsigdx[:, None, :]
        d2sigdx2 = (d2sig2 - 2.0 * outer) / (2.0 * sig_mod[:, None, None])

    return mu, sig, dmudx, dsigdx, d2mudx2, d2sigdx2


def eval_model_var(cfg: GpConfig, spec: DataSpec, data: GpData,
                   state: EvalState, xq: torch.Tensor,
                   calc_grad: bool = False, calc_hess: bool = False):
    """Variance (not std) and its derivatives."""
    hp = state.hp
    nx, dim = xq.shape
    dt = _predict_dtype(cfg)
    data, xq = cast_float_tree(data, dt), xq.to(dt)
    varK = hp.varK

    Kyx, dKxy_dx = _cross_cov(cfg, spec, data.x, xq, hp)
    Kxy_invK = _ops_solve(cfg, state.ops, Kyx).T
    sig2 = varK * torch.clamp_min(1.0 - torch.sum(Kyx.T * Kxy_invK, dim=1), 0.0)

    dsig2dx = d2sig2dx2 = None
    if calc_grad:
        term2 = torch.sum(dKxy_dx * Kxy_invK.repeat(dim, 1), dim=1)
        dsig2dx = -2.0 * term2.reshape(dim, nx).T * varK
    if calc_hess:
        _, d2sig2dx2 = _hess_terms(cfg, spec, data, state, xq, Kxy_invK,
                                   dKxy_dx)
    return sig2, dsig2dx, d2sig2dx2
