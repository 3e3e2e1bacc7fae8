"""Marginal log-likelihood (MLL) in both noise regimes, with hyperparameter
gradients by autograd (counterpart of ``gpgradpy_tpu/model/likelihood.py``).

Noise-free regime (b_has_noisy_data False): varK and beta are profiled out in
closed form,
    beta = GLS(V, Keta, y),   varK = r^T Keta^-1 r / n,
    ln L = -(n ln varK + ln det Keta) / 2 - penalty
Noisy regime: varK (and the unknown noise variances) are numeric
hyperparameters and
    ln L = -(ln det Kcov + r^T Kcov^-1 r) / 2,   Kcov = varK * Keta(noise/varK).

Every function evaluates a batch of hyperparameter rows at once when given
one (``hp_vec`` of shape (B, n_hp)); the rows are independent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GpConfig
from ..ops import rtensor
from ..types import DataSpec, GpData, HpInfo, Hypers, hp_vec_to_hypers
from . import assembly, mean


class LkdInfo(NamedTuple):
    ln_lkd: torch.Tensor
    beta: torch.Tensor
    varK: torch.Tensor
    ln_det: torch.Tensor
    cond: torch.Tensor
    etaK: torch.Tensor
    ok: torch.Tensor


def make_data_vec(spec: DataSpec, data: GpData) -> torch.Tensor:
    return rtensor.make_data_vec(data.fval, data.grad if spec.use_grad else None)


def _varK_penalty(cfg: GpConfig, varK, fval):
    """Penalty discouraging large varK."""
    if not cfg.lkd_varK_pnlt_use:
        return 0.0
    var_fval = torch.clamp_min(torch.var(fval, correction=0),
                               cfg.lkd_varK_pnlt_lb_var)
    max_fun = torch.clamp_min(varK - cfg.lkd_varK_pnlt_c2 * var_fval, 0.0)
    return cfg.lkd_varK_pnlt_c1 * var_fval * max_fun ** 2


def calc_lkd(cfg: GpConfig, spec: DataSpec, data: GpData, hp: Hypers,
             eta_const: float, calc_cond: bool = False, mesh=None) -> LkdInfo:
    """MLL and closed-form hyperparameters, differentiable in (theta,
    kernel, varK, var_fval, var_fgrad).  With ``mesh`` the covariance is
    factored by the distributed Cholesky (``assemble_keta(mesh=)``, one
    hyperparameter row)."""
    data_vec = make_data_vec(spec, data)
    n_data = spec.n_data          # REAL data count (padding masked out)
    vand = mean.calc_aug_vand(cfg.mean_fun_type, data.x, spec.use_grad,
                              spec.idx_grad_arr)
    pad_mask = spec.pad_mask()
    if pad_mask is not None:
        mv = torch.as_tensor(pad_mask, dtype=vand.dtype, device=vand.device)
        vand = vand * mv[:, None]
        data_vec = data_vec * mv

    if spec.b_has_noisy_data:
        varK = hp.varK
        ops = assembly.assemble_keta(cfg, spec, data, hp, eta_const, varK=varK,
                                     mesh=mesh)
        beta, mean_vec = mean.gls_beta_precon(vand, ops.fac, ops.pvec, data_vec)
        r = data_vec - mean_vec
        alpha = ops.solve(r)
        ln_det_Kcov = n_data * torch.log(varK) + ops.logdet
        quad = (r * alpha).sum(-1) / varK
        ln_lkd = -(ln_det_Kcov + quad) / 2.0
        ln_det = ln_det_Kcov
    else:
        ops = assembly.assemble_keta(cfg, spec, data, hp, eta_const, varK=None,
                                     mesh=mesh)
        beta, mean_vec = mean.gls_beta_precon(vand, ops.fac, ops.pvec, data_vec)
        r = data_vec - mean_vec
        alpha = ops.solve(r)
        varK = torch.clamp_min((r * alpha).sum(-1) / n_data, cfg.varK_min)
        pnlt = _varK_penalty(cfg, varK, data.fval)
        ln_lkd = -(n_data * torch.log(varK) + ops.logdet) / 2.0 - pnlt
        ln_det = ops.logdet

    cond = (assembly.calc_cond(ops, cfg.cond_norm) if calc_cond
            else torch.full_like(ln_lkd, float("nan")))
    return LkdInfo(ln_lkd=ln_lkd, beta=beta, varK=varK, ln_det=ln_det,
                   cond=cond, etaK=ops.etaK, ok=ops.ok)


# ---------------------------------------------------------------------------
# Optimization objectives on the flat hp vector
# ---------------------------------------------------------------------------

def neg_mll(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
            hp_vec: torch.Tensor, eta_const: float, mesh=None):
    """-ln L of the flat (log-space) hp vector (n_hp,) or (B, n_hp), with
    the JAX package's feasibility-restoring fallback where the Cholesky
    fails: a surrogate that decreases in sum(log10 theta), since a larger
    theta decorrelates K and improves its conditioning."""
    hp = hp_vec_to_hypers(info, hp_vec)
    lkd = calc_lkd(cfg, spec, data, hp, eta_const, calc_cond=False, mesh=mesh)
    th = hp_vec[..., : info.dim]
    log10_th = th if info.log_theta else torch.log10(th)
    softplus = torch.logaddexp(-log10_th, torch.zeros_like(log10_th))
    fallback = 1e12 * (1.0 + softplus.mean(-1))
    val = torch.where(lkd.ok, -lkd.ln_lkd, fallback)
    # keep the gradient finite when the lkd branch produced NaNs
    val = torch.where(torch.isfinite(val), val, fallback)
    return val, lkd


def neg_mll_and_grad(cfg: GpConfig, spec: DataSpec, info: HpInfo,
                     data: GpData, hp_vec: torch.Tensor, eta_const: float,
                     mesh=None):
    """(-ln L, its gradient in hp_vec, LkdInfo), per row of hp_vec."""
    v = hp_vec.detach().requires_grad_(True)
    with torch.enable_grad():
        val, lkd = neg_mll(cfg, spec, info, data, v, eta_const, mesh=mesh)
        g, = torch.autograd.grad(val.sum(), v)
    g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
    lkd = LkdInfo(*(t.detach() for t in lkd))
    return val.detach(), g, lkd


def calc_lkd_hp_vec(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
                    hp_vec: torch.Tensor, eta_const: float,
                    calc_cond: bool = False, mesh=None) -> LkdInfo:
    hp = hp_vec_to_hypers(info, hp_vec)
    return calc_lkd(cfg, spec, data, hp, eta_const, calc_cond=calc_cond,
                    mesh=mesh)


def closed_form_hp(cfg: GpConfig, spec: DataSpec, data: GpData, hp: Hypers,
                   eta_const: float) -> Hypers:
    """Fill in beta (and varK in the noise-free regime) with their
    closed-form maximizers."""
    lkd = calc_lkd(cfg, spec, data, hp, eta_const)
    varK = hp.varK if spec.b_has_noisy_data else lkd.varK
    return hp._replace(beta=lkd.beta, varK=varK)
