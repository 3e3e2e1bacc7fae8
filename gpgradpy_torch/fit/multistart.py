"""Multistart MAP fitting of the hyperparameters
(counterpart of ``gpgradpy_tpu/fit/multistart.py``).

Start points are LHS samples around the median of recent hyperparameters;
with 'hp_best' the MLL is evaluated at all candidates as one batch on the
device and the best one starts a box-constrained L-BFGS.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import GpConfig
from ..model import likelihood
from ..types import DataSpec, GpData, HpInfo
from . import lbfgs, lhs


class HpBounds(NamedTuple):
    lhs_lb: np.ndarray
    lhs_ub: np.ndarray
    box_lb: np.ndarray
    box_ub: np.ndarray


def _median_range(past_vals: Optional[np.ndarray], vrange, lhs_f, box_f):
    """Per-hyperparameter LHS/box bounds around the median of recent values."""
    if past_vals is None or past_vals.size == 0:
        med = np.sqrt(vrange[0] * vrange[1])  # geometric centre of the range
    else:
        med = np.median(past_vals, axis=0)
    med = np.clip(med, vrange[0], vrange[1])
    return (np.maximum(med / lhs_f, vrange[0]), np.minimum(med * lhs_f, vrange[1]),
            np.maximum(med / box_f, vrange[0]), np.minimum(med * box_f, vrange[1]))


def get_hp_bounds(cfg: GpConfig, info: HpInfo, history=None,
                  i_optz: int = 0) -> HpBounds:
    """LHS and box bounds in optimization (log) space."""
    lhs_f = cfg.hp_lhs_bound_factor
    box_f = cfg.hp_box_bound_factor
    idx_min = max(0, i_optz - cfg.hp_median_n_idx)

    def past(name):
        if history is None or i_optz <= idx_min:
            return None
        arr = np.asarray(getattr(history, name)[idx_min:i_optz], float)
        if arr.ndim == 1:
            arr = arr[:, None]
        arr = arr[np.all(np.isfinite(arr), axis=1)]
        return arr if arr.size else None

    cols = []
    if info.has_theta:
        th_past = past("hp_theta")
        if th_past is None:
            th_past = np.full((1, cfg.dim), cfg.hp_theta_init)
        lo_l, hi_l, lo_b, hi_b = _median_range(th_past, cfg.hp_theta_range,
                                               lhs_f, box_f)
        cols.append(np.stack([lo_l * np.ones(cfg.dim), hi_l * np.ones(cfg.dim),
                              lo_b * np.ones(cfg.dim), hi_b * np.ones(cfg.dim)], 1))

    def scalar_bounds(name, vrange, init):
        arr = past(name)
        if arr is None:
            arr = np.array([[np.clip(init, *vrange)]])
        lo_l, hi_l, lo_b, hi_b = _median_range(arr, vrange, lhs_f, box_f)
        return np.stack([lo_l, hi_l, lo_b, hi_b], 1)

    if info.has_kernel:
        cols.append(scalar_bounds("hp_kernel", cfg.hp_kernel_range,
                                  cfg.hp_kernel_default))
    if info.has_varK:
        cols.append(scalar_bounds("hp_varK", cfg.hp_varK_range, cfg.hp_varK_init))
    if info.has_var_fval:
        cols.append(scalar_bounds("hp_var_fval", cfg.hp_var_fval_range,
                                  max(cfg.hp_var_fval_init, cfg.hp_var_fval_range[0])))
    if info.has_var_fgrad:
        cols.append(scalar_bounds("hp_var_fgrad", cfg.hp_var_fgrad_range,
                                  max(cfg.hp_var_fgrad_init, cfg.hp_var_fgrad_range[0])))

    b = np.concatenate(cols, axis=0)
    lhs_lb, lhs_ub, box_lb, box_ub = b[:, 0], b[:, 1], b[:, 2], b[:, 3]

    bvec = info.bvec_log
    for arr in (lhs_lb, lhs_ub, box_lb, box_ub):
        arr[bvec] = np.log10(arr[bvec])
    return HpBounds(lhs_lb, lhs_ub, box_lb, box_ub)


class FitResult(NamedTuple):
    hp_vec: np.ndarray      # best hp in optimization space
    neg_lkd: float
    cond: float
    info: dict              # optimizer telemetry


def hp_rows(cfg: GpConfig, data: GpData, X) -> torch.Tensor:
    """Host hp vectors as a tensor of the model's dtype on its device."""
    dt = torch.float64 if cfg.dtype == "float64" else torch.float32
    return torch.as_tensor(np.asarray(X), dtype=dt, device=data.x.device)


def scan_neg_mll(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
                 eta_const: float, X):
    """The start scan: -ln L (with the restoring surrogate) of every row of
    X in one batched evaluation.  Returns the values on the host, inf where
    not finite, and the number of rows whose Cholesky failed."""
    with torch.no_grad():
        vals, lkd = likelihood.neg_mll(cfg, spec, info, data,
                                       hp_rows(cfg, data, X), eta_const)
    vals = vals.cpu().numpy()
    return np.where(np.isfinite(vals), vals, np.inf), int((~lkd.ok).sum())


def lkd_cond_at(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
                eta_const: float, X) -> likelihood.LkdInfo:
    """MLL and condition number at hp vector(s) X (counterpart of
    ``_jit_lkd_cond``, multistart.py:120 of the JAX package)."""
    with torch.no_grad():
        return likelihood.calc_lkd_hp_vec(cfg, spec, info, data,
                                          hp_rows(cfg, data, X), eta_const,
                                          calc_cond=True)


def neg_mll_objective(cfg: GpConfig, spec: DataSpec, info: HpInfo,
                      data: GpData, eta_const: float):
    """The L-BFGS objective of the fit: rows X (b, n_hp) on the host ->
    (-ln L (b,), its gradient (b, n_hp), aux (b,)), one batched evaluation;
    aux is 1 where the Cholesky failed and the restoring surrogate fired."""
    def obj(X):
        val, g, lkd = likelihood.neg_mll_and_grad(cfg, spec, info, data,
                                                  hp_rows(cfg, data, X),
                                                  eta_const)
        return (val.cpu().numpy(), g.cpu().numpy(),
                (~lkd.ok).to(val.dtype).cpu().numpy())
    return obj


def fit_map(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
            eta_const: float, history=None, i_optz: int = 0,
            seed: int = 1, x0_override=None, with_cond: bool = True,
            hp_prev=None) -> FitResult:
    """One full MAP hyperparameter fit: bounds -> starts -> batched L-BFGS ->
    best solution + final condition number.

    x0_override (k, n_hp) replaces the LHS/hp_best start policy.  hp_prev,
    when given, joins the start-candidate pool (as its last row; without it
    the pool repeats its first row, as in the JAX package)."""
    np_dt = np.float64 if cfg.dtype == "float64" else np.float32
    bounds = get_hp_bounds(cfg, info, history, i_optz)
    if x0_override is not None:
        hp_best = False
        x0_np = np.atleast_2d(np.asarray(x0_override, float))
    else:
        hp_best = cfg.lkd_optz_start_mtd == "hp_best"
        if not hp_best and cfg.lkd_optz_start_mtd != "lhs":
            raise ValueError(
                f"Unknown lkd_optz_start_mtd: {cfg.lkd_optz_start_mtd}")
        n0 = cfg.lkd_hp_best_n_eval if hp_best else cfg.optz_n_x0
        x0_np = np.asarray(lhs.lhs_sample(n0, bounds.lhs_lb, bounds.lhs_ub,
                                          seed))
        if hp_best:
            extra = (np.clip(np.asarray(hp_prev, float).ravel(),
                             bounds.box_lb, bounds.box_ub)
                     if hp_prev is not None else x0_np[0])
            x0_np = np.vstack([x0_np, extra[None, :]])
        elif hp_prev is not None:
            x0_np = np.vstack([x0_np, np.clip(
                np.asarray(hp_prev, float).ravel(),
                bounds.box_lb, bounds.box_ub)[None, :]])
    x0_np = x0_np.astype(np_dt)

    n_fail_scan = 0
    starts = x0_np
    if hp_best:
        vals, n_fail_scan = scan_neg_mll(cfg, spec, info, data, eta_const,
                                         x0_np)
        starts = x0_np[np.argmin(vals)][None, :]

    def cond_at(X):
        return lkd_cond_at(cfg, spec, info, data, eta_const, X).cond

    init_cond = (float(cond_at(starts).max()) if with_cond
                 else float("nan"))

    obj = neg_mll_objective(cfg, spec, info, data, eta_const)
    res = lbfgs.lbfgs_box_multistart(obj, starts, bounds.box_lb.astype(np_dt),
                                     bounds.box_ub.astype(np_dt),
                                     max_iter=cfg.optz_iter_max,
                                     tol_f=cfg.optz_tol_obj)
    fvals = np.where(np.isfinite(res.f), res.f, np.inf)
    best = int(np.argmin(fvals))
    best_hp = res.x[best]
    cond = (float(cond_at(best_hp[None, :])[0]) if with_cond
            else float("nan"))
    tele = {
        "hp_optz_success": float(np.mean(res.converged)),
        "hp_optz_iter_mean": float(np.mean(res.n_iter)),
        "hp_optz_iter_max": float(np.max(res.n_iter)),
        "hp_optz_con_good": 1.0,
        # visited iterates (start scan + accepted L-BFGS steps) whose
        # Cholesky failed and the restoring fallback objective fired
        "optz_n_cho_fail": int(round(n_fail_scan + float(np.sum(res.aux_sum)))),
        "optz_n_cond2big": 0,
        "optz_max_init_cond": init_cond,
    }
    return FitResult(hp_vec=best_hp, neg_lkd=float(fvals[best]), cond=cond,
                     info=tele)
