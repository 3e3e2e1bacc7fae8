"""MAP hyperparameter fitting through the matrix-free CG + SLQ marginal
likelihood (counterpart of ``gpgradpy_tpu/fit/iterative_driver.py``).

Same contract as ``fit/multistart.fit_map`` (bounds -> LHS starts -> box
L-BFGS -> FitResult), every objective evaluation a matrix-free MLL
estimate: O(n_data^2) time and O(n_data * row_block) memory.  The host
L-BFGS of ``fit/lbfgs.py`` drives it; its objective evaluates the rows of
a step one after another.

The probes are drawn once per fit, so the estimated MLL is a deterministic
function of the hyperparameters: an (n_full, iter_n_probes) Rademacher
matrix from a CPU ``torch.Generator`` seeded with ``seed + 7 * i_optz`` (the
seed of the JAX package's key), moved to the model's device, so a card fit
and a CPU fit see the same probes.  ``probes=`` overrides it (the tests hand
in the JAX package's).  With ``mesh`` the probes are in the point-major
working layout of the sharded matvec, as the JAX package draws them there,
and every rank draws the same ones.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GpConfig
from ..model import likelihood_iter
from ..ops import iterative
from ..types import DataSpec, GpData, HpInfo, Hypers, hp_vec_to_hypers
from . import lbfgs, lhs
from .multistart import FitResult, get_hp_bounds, hp_rows


def _grad_hp_to_vec(info: HpInfo, hp: Hypers, ghp: Hypers) -> torch.Tensor:
    """Chain d(-lnL)/d(hp values) into optimization (log10) space, in the
    hp_vec layout of types.hp_vec_to_hypers."""
    def parts(h):
        out = [torch.atleast_1d(h.theta)]
        for name in ("kernel", "varK", "var_fval", "var_fgrad"):
            if getattr(info, f"has_{name}"):
                out.append(torch.atleast_1d(getattr(h, name)))
        return torch.cat(out)

    g, vals = parts(ghp), parts(hp)
    bvec = torch.as_tensor(info.bvec_log, device=g.device)
    return torch.where(bvec, g * vals * np.log(10.0), g)


def iter_kw(cfg: GpConfig) -> dict:
    return dict(max_cg_iters=cfg.iter_max_cg, cg_tol=cfg.iter_cg_tol,
                row_block=cfg.iter_row_block)


def fit_map_iterative(cfg: GpConfig, spec: DataSpec, info: HpInfo,
                      data: GpData, eta_const: float, history=None,
                      i_optz: int = 0, seed: int = 1, x0_override=None,
                      probes=None, mesh=None, **_ignored) -> FitResult:
    """Large-n MAP fit: LHS starts around the median of recent
    hyperparameters -> L-BFGS through the CG/SLQ MLL -> FitResult.  No
    condition number is computed (there is no factorization): cond is NaN
    and the telemetry carries the CG residual and iterations instead."""
    if info.has_kernel:
        raise NotImplementedError(
            "iterative fit: kernel-family hyperparameters (RatQu alpha) are "
            "not in the determinant-free gradient yet -- use solver='dense'")
    np_dt = np.float64 if cfg.dtype == "float64" else np.float32
    bounds = get_hp_bounds(cfg, info, history, i_optz)
    if x0_override is not None:
        x0_all = np.atleast_2d(np.asarray(x0_override, float))
    else:
        x0_all = np.asarray(lhs.lhs_sample(cfg.iter_n_x0, bounds.lhs_lb,
                                           bounds.lhs_ub, seed))
    dt, dev = data.x.dtype, data.x.device
    n_full = spec.n_eval * (1 + spec.dim)
    if probes is None:
        z = iterative.rademacher(n_full, cfg.iter_n_probes, seed + 7 * i_optz,
                                 dt, dev)
    else:
        z = torch.as_tensor(np.array(probes), dtype=dt, device=dev)
    kw = dict(iter_kw(cfg), mesh=mesh)
    noisy = spec.b_has_noisy_data
    n_val = [0]

    def one(v):
        n_val[0] += 1
        hp = hp_vec_to_hypers(info, v)
        if noisy:
            val, ghp, _ = likelihood_iter.neg_mll_iterative_noisy_and_grad(
                cfg, spec, data, hp, eta_const, z, **kw)
        else:
            val, gth, _ = likelihood_iter.neg_mll_iterative_and_grad(
                cfg, spec, data, hp, eta_const, z, **kw)
            ghp = hp._replace(theta=gth)
        gvec = _grad_hp_to_vec(info, hp, ghp)
        return val, torch.where(torch.isfinite(gvec), gvec,
                                torch.zeros_like(gvec))

    def obj(X):
        vals, grads = zip(*(one(v) for v in hp_rows(cfg, data, X)))
        return (torch.stack(vals).cpu().numpy(),
                torch.stack(grads).cpu().numpy(), np.zeros(len(X)))

    res = lbfgs.lbfgs_box_multistart(obj, x0_all.astype(np_dt),
                                     bounds.box_lb.astype(np_dt),
                                     bounds.box_ub.astype(np_dt),
                                     max_iter=cfg.optz_iter_max,
                                     tol_f=cfg.optz_tol_obj)
    fvals = np.where(np.isfinite(res.f), res.f, np.inf)
    best = int(np.argmin(fvals))
    best_hp = res.x[best]
    # one final estimate at the winner for telemetry (CG residual, iterations)
    calc = (likelihood_iter.calc_lkd_iterative_noisy if noisy
            else likelihood_iter.calc_lkd_iterative)
    lkd = calc(cfg, spec, data,
               hp_vec_to_hypers(info, hp_rows(cfg, data, best_hp)),
               eta_const, z, **kw)
    tele = {
        "hp_optz_success": float(np.mean(res.converged)),
        "hp_optz_iter_mean": float(np.mean(res.n_iter)),
        "hp_optz_iter_max": float(np.max(res.n_iter)),
        "hp_optz_con_good": 1.0,
        "optz_n_cho_fail": 0,          # no factorization on this path
        "optz_n_cond2big": 0,
        "optz_max_init_cond": float("nan"),
        "iter_cg_resid": float(lkd.cg_resid),
        "iter_cg_iters": int(lkd.cg_iters),
        "optz_n_val": n_val[0],        # objective (value + gradient) calls
    }
    return FitResult(hp_vec=best_hp, neg_lkd=float(fvals[best]),
                     cond=float("nan"), info=tele)
