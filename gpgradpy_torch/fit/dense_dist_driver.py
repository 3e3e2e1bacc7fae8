"""Mid-n MAP fit through the DISTRIBUTED blocked Cholesky (facade entry
``solver="dense_dist"``; counterpart of
``gpgradpy_tpu/fit/dense_dist_driver.py``).

The exact dense MLL of ``model/likelihood.py`` (same nugget, precon trick,
closed forms, autograd gradients), with every factorization of the fit
routed through ``parallel/chol_dist.py``: the O(n^3) flops split row-wise
over the ranks of the mesh.  The covariance is assembled whole on every
rank (K1; its theta cotangent K2), and the Cholesky's pullback runs on the
gathered factor on every rank, as the dense path's does.

CG against direct (which large-n solver): ``solver="iterative"`` costs
O(k n^2) with k ~ sqrt(cond) CG iterations and wins while k << n /
world_size; ``"dense_dist"`` costs O(n^3 / world_size) plus O(n b) bytes of
collectives per block step and wins at mid n once k exceeds ~n /
world_size (tight condition targets), or where the exact log-determinant
and condition number of a factorization are wanted.

At mid n the matrix is what is split, not the starts: the hp_best
candidate scan evaluates one start at a time, then a single-start L-BFGS
runs from the best (the reference's 'hp_best' policy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import GpConfig
from ..model import likelihood
from ..types import DataSpec, GpData, HpInfo
from . import lbfgs, lhs
from .multistart import FitResult, get_hp_bounds, hp_rows


def fit_map_dense_dist(cfg: GpConfig, spec: DataSpec, info: HpInfo,
                       data: GpData, eta_const: float, history=None,
                       i_optz: int = 0, seed: int = 1, x0_override=None,
                       mesh=None, hp_prev=None, **_ignored) -> FitResult:
    """Mid-n MAP fit with the covariance factorization distributed over
    ``mesh`` (the contract of ``multistart.fit_map``).  Every rank runs it
    and gets the same result."""
    if mesh is None:
        raise ValueError("solver='dense_dist' needs a mesh "
                         "(parallel.mesh.make_mesh)")
    if cfg.wellcond_mtd != "precon":
        raise ValueError(
            "solver='dense_dist' runs the unconstrained (precon) fit; the "
            "cond-constrained methods (base/rescale) need the scipy SLSQP "
            "driver, which is dense-only -- use solver='dense'")
    blk = cfg.dist_chol_block
    if spec.n_data_tot % (mesh.size * blk):
        raise ValueError(
            f"dense_dist: n_data_tot={spec.n_data_tot} must be a multiple of "
            f"mesh.size*dist_chol_block={mesh.size * blk}.  The facade pads "
            f"onto this grid in set_data; direct driver callers size (or "
            f"pad) the spec themselves")
    # the telemetry cond through the factor (Frobenius), never eigh at mid n
    if cfg.cond_norm != "fro":
        cfg = dataclasses.replace(cfg, cond_norm="fro")

    np_dt = np.float64 if cfg.dtype == "float64" else np.float32
    bounds = get_hp_bounds(cfg, info, history, i_optz)
    if x0_override is not None:
        hp_best = False
        x0_np = np.atleast_2d(np.asarray(x0_override, float))
    else:
        hp_best = cfg.lkd_optz_start_mtd == "hp_best"
        n0 = cfg.lkd_hp_best_n_eval if hp_best else 1
        x0_np = np.asarray(lhs.lhs_sample(n0, bounds.lhs_lb, bounds.lhs_ub,
                                          seed))
        # the candidate pool always holds the hp_prev slot (the JAX
        # package's static pool shape): with no previous round it repeats
        # the first LHS row
        hp_prev_row = (np.clip(np.asarray(hp_prev, float).ravel(),
                               bounds.box_lb, bounds.box_ub)[None, :]
                       if hp_prev is not None else x0_np[:1])
        # hp_best: it joins the argmin pool; otherwise the warm start must
        # BE the first row, or it is never used
        x0_np = np.vstack([x0_np, hp_prev_row]) if hp_best else hp_prev_row
    x0_np = x0_np.astype(np_dt)

    n_fail_scan = 0
    start = x0_np[:1]
    if hp_best:
        # one candidate at a time: each factorization occupies every rank
        vals = np.empty(len(x0_np))
        with torch.no_grad():
            for i, row in enumerate(x0_np):
                val, lkd = likelihood.neg_mll(cfg, spec, info, data,
                                              hp_rows(cfg, data, row),
                                              eta_const, mesh=mesh)
                vals[i] = float(val)
                n_fail_scan += int(not bool(lkd.ok))
        vals = np.where(np.isfinite(vals), vals, np.inf)
        start = x0_np[np.argmin(vals)][None, :]

    def obj(X):
        out = [likelihood.neg_mll_and_grad(cfg, spec, info, data,
                                           hp_rows(cfg, data, row),
                                           eta_const, mesh=mesh)
               for row in X]
        return (np.array([float(v) for v, _, _ in out]),
                np.stack([g.cpu().numpy() for _, g, _ in out]),
                np.array([1.0 - float(lkd.ok) for _, _, lkd in out]))

    res = lbfgs.lbfgs_box_multistart(obj, start, bounds.box_lb.astype(np_dt),
                                     bounds.box_ub.astype(np_dt),
                                     max_iter=cfg.optz_iter_max,
                                     tol_f=cfg.optz_tol_obj)
    best_hp = res.x[0]
    with torch.no_grad():
        lkd = likelihood.calc_lkd_hp_vec(cfg, spec, info, data,
                                         hp_rows(cfg, data, best_hp),
                                         eta_const, calc_cond=True, mesh=mesh)
    tele = {
        "hp_optz_success": float(res.converged[0]),
        "hp_optz_iter_mean": float(res.n_iter[0]),
        "hp_optz_iter_max": float(res.n_iter[0]),
        "hp_optz_con_good": 1.0,
        "optz_n_cho_fail": float(n_fail_scan + res.aux_sum[0]),
        "optz_n_cond2big": 0.0,
        "dist_mesh_devices": int(mesh.size),
        "dist_chol_block": int(blk),
    }
    return FitResult(hp_vec=best_hp, neg_lkd=float(res.f[0]),
                     cond=float(lkd.cond), info=tele)
