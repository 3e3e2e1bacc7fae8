"""Scipy SLSQP / trust-constr driver for the hyperparameter fit, with the
exact condition-number constraint (counterpart of
``gpgradpy_tpu/fit/scipy_driver.py``).

Every conditioning method but 'precon' fits here, under cond <= cond_max;
so does any method with ``optz_mtd`` 'slsqp' or 'trust-constr'.  scipy
drives the outer iteration on the host, one start after the other.  Each
callback evaluates on the model's device: the covariance (K1 on a card),
its Cholesky, the MLL and the condition number (eigh or Cholesky solves),
and their gradients by autograd (K2 on a card).  Only scalars and
hp-length gradients cross to the host.

scipy hands the callbacks float64 vectors; a float32 model is evaluated in
float32 (the vector is rounded to the model's dtype, as the kernels take
one dtype) and its results go back to scipy as float64.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.optimize import Bounds, NonlinearConstraint, minimize

from ..config import GpConfig
from ..model import assembly, likelihood
from ..types import DataSpec, GpData, HpInfo, hp_vec_to_hypers
from . import lhs
from .multistart import (FitResult, HpBounds, get_hp_bounds, hp_rows,
                         lkd_cond_at, scan_neg_mll)


class Evaluation(NamedTuple):
    """What one evaluation brought to the host (None where not asked)."""
    val: float      # ln L (not negated)
    ok: bool        # Cholesky success
    cond: float
    grad: np.ndarray
    cond_grad: np.ndarray


def evaluate(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
             eta_const: float, x, with_lkd: bool, with_cond: bool,
             with_grad: bool) -> Evaluation:
    """ln L and/or the condition number at the hp vector x from ONE forward
    (one assembly, one Cholesky), with their gradients when asked: two
    ``autograd.grad`` calls on that graph, the first retaining it.  The
    MLL is the raw ``calc_lkd`` value and ``ok`` flag, without the
    surrogate of ``likelihood.neg_mll``: the failure ladder of the callers
    decides what a failed Cholesky means here."""
    v = hp_rows(cfg, data, x)
    with torch.set_grad_enabled(with_grad):
        v.requires_grad_(with_grad)
        hp = hp_vec_to_hypers(info, v)
        if with_lkd:
            lkd = likelihood.calc_lkd(cfg, spec, data, hp, eta_const,
                                      calc_cond=with_cond)
            val, ok, cond = lkd.ln_lkd, lkd.ok, lkd.cond
        else:
            ops = assembly.assemble_keta(
                cfg, spec, data, hp, eta_const,
                varK=hp.varK if spec.b_has_noisy_data else None)
            cond = assembly.calc_cond(ops, cfg.cond_norm)
            val, ok = torch.full_like(cond, float("nan")), ops.ok
        wanted = [(name, t) for name, t, want in (("grad", val, with_lkd),
                                                  ("cond_grad", cond, with_cond))
                  if want and with_grad]
        grads = {name: torch.autograd.grad(t, v,
                                           retain_graph=i + 1 < len(wanted))[0]
                 for i, (name, t) in enumerate(wanted)}
    # one transfer to the host: the three scalars and the gradients
    host = torch.cat([torch.stack([val.detach(), ok.to(val.dtype),
                                   cond.detach()]), *grads.values()])
    host = host.double().cpu().numpy()
    n = v.shape[-1]
    got = {name: host[3 + i * n: 3 + (i + 1) * n]
           for i, name in enumerate(grads)}
    return Evaluation(val=float(host[0]), ok=bool(host[1]),
                      cond=float(host[2]), grad=got.get("grad"),
                      cond_grad=got.get("cond_grad"))


class _Memo:
    """Memoized lazy scipy callbacks bound to one (data, eta) instance, with
    the JAX package's failure semantics: where the fit fails at an iterate,
    the condition number becomes the objective.

    Per iterate x, each of {MLL value, MLL gradient, cond value, cond
    gradient} is computed at most once and only when scipy asks for it.
    With the constraint active, the cond value is evaluated at every new x
    (the cond_max_abs rung of the failure ladder is part of the objective),
    in the same forward as the MLL value; the two gradients of an accepted
    iterate come from one forward as well."""

    def __init__(self, cfg: GpConfig, spec: DataSpec, info: HpInfo,
                 data: GpData, eta_const: float, use_cstr: bool):
        self.cfg = cfg
        self.use_cstr = use_cstr
        self._args = (cfg, spec, info, data, eta_const)
        self.last_x = None
        self.n_cho_fail = 0
        # evaluation counters (telemetry: how lazy the callbacks were)
        self.n_val = self.n_grad = self.n_cond = self.n_cond_grad = 0

    def _eval(self, with_lkd, with_cond, with_grad):
        return evaluate(*self._args, self.last_x, with_lkd, with_cond,
                        with_grad)

    def _sync(self, x):
        x = np.atleast_1d(np.asarray(x, float)).ravel()
        if self.last_x is not None and np.array_equal(x, self.last_x):
            return
        self.last_x = x.copy()
        self._val = self._ok = self._grad = None
        self._cond = self._cond_grad = None
        self._failed = None

    def _ensure_val(self):
        if self._val is None:
            self.n_val += 1
            e = self._eval(True, self.use_cstr, False)
            if self.use_cstr:
                self._cond = e.cond
                self.n_cond += 1
            self._val, self._ok = e.val, e.ok

    def _ensure_grad(self):
        if self._grad is None:
            self.n_grad += 1
            both = self.use_cstr and self._cond_grad is None
            e = self._eval(True, both, True)
            if both:
                self._cond, self._cond_grad = e.cond, e.cond_grad
                self.n_cond_grad += 1
            self._val, self._ok, self._grad = e.val, e.ok, e.grad

    def _ensure_cond(self):
        if self._cond is None:
            self.n_cond += 1
            self._cond = self._eval(False, True, False).cond

    def _ensure_cond_grad(self):
        if self._cond_grad is None:
            self.n_cond_grad += 1
            if self.use_cstr and self._grad is None and not self._failed:
                # scipy may ask the constraint's jacobian first: fetch both
                self._ensure_grad()
                return
            e = self._eval(False, True, True)
            self._cond, self._cond_grad = e.cond, e.cond_grad

    def _ensure_failed(self):
        """Failure ladder: Cholesky not ok, non-finite MLL, or (with the
        constraint active) cond beyond cond_max_abs."""
        if self._failed is not None:
            return
        self._ensure_val()
        failed = (not self._ok) or not np.isfinite(self._val)
        if self.use_cstr or failed:
            self._ensure_cond()
            if self._cond > self.cfg.cond_max_abs:
                failed = True
        if failed:
            self.n_cho_fail += 1
        self._failed = failed

    # scipy-facing accessors --------------------------------------------

    def obj_val(self, x):
        self._sync(x)
        self._ensure_failed()
        if self._failed:
            self._ensure_cond()
            return self._cond          # minimize cond instead
        return -self._val

    def obj_grad(self, x):
        self._sync(x)
        self._ensure_failed()
        if self._failed:
            self._ensure_cond_grad()
            return self._cond_grad
        self._ensure_grad()
        return -self._grad

    def cond(self, x):
        self._sync(x)
        self._ensure_cond()
        return self._cond

    def cond_grad(self, x):
        self._sync(x)
        self._ensure_cond_grad()
        return self._cond_grad


def _select_x0_w_prev(cfg: GpConfig, spec: DataSpec, info: HpInfo,
                      data: GpData, eta_const: float, bounds: HpBounds,
                      seed: int, hp_prev) -> np.ndarray:
    """Starts: 'lhs' -> optz_n_x0 LHS samples; 'hp_best' -> the best of
    lkd_hp_best_n_eval LHS samples by -ln L, one batched evaluation.  The
    previous round's optimum, when given, joins the pool (one more start in
    'lhs', one more candidate in 'hp_best')."""
    mode = cfg.lkd_optz_start_mtd
    if mode not in ("lhs", "hp_best"):
        raise ValueError(f"Unknown lkd_optz_start_mtd: {mode}")
    n0 = cfg.optz_n_x0 if mode == "lhs" else cfg.lkd_hp_best_n_eval
    x0 = lhs.lhs_sample(n0, bounds.lhs_lb, bounds.lhs_ub, seed)
    if hp_prev is not None:
        prev = np.clip(np.asarray(hp_prev, float).ravel(), bounds.box_lb,
                       bounds.box_ub)
        x0 = np.vstack([x0, prev[None, :]])
    if mode == "lhs":
        return x0
    vals, _ = scan_neg_mll(cfg, spec, info, data, eta_const, x0)
    return x0[int(np.argmin(vals))][None, :]


def fit_map_scipy(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
                  eta_const: float, history=None, i_optz: int = 0,
                  seed: int = 1, x0_override=None,
                  hp_prev=None) -> FitResult:
    """One MAP fit: starts -> scipy per start -> best feasible optimum ->
    its condition number.  x0_override (k, n_hp) replaces the start policy
    (the rescale fixed-point loop's warm start)."""
    bounds = get_hp_bounds(cfg, info, history, i_optz)
    if x0_override is not None:
        x0_all = np.atleast_2d(np.asarray(x0_override, float))
    else:
        x0_all = _select_x0_w_prev(cfg, spec, info, data, eta_const, bounds,
                                   seed, hp_prev)
    use_cstr = cfg.b_use_cond_cstr
    memo = _Memo(cfg, spec, info, data, eta_const, use_cstr)

    constraints = []
    if use_cstr:
        constraints = [NonlinearConstraint(memo.cond, -np.inf, cfg.cond_max,
                                           jac=memo.cond_grad)]
    if cfg.optz_mtd == "trust-constr":
        method = "trust-constr"
        opt = {"initial_tr_radius": 0.1, "xtol": cfg.optz_tol_x,
               "gtol": cfg.optz_tol_obj, "maxiter": cfg.optz_iter_max,
               "disp": False}
    else:
        method = "SLSQP"
        opt = {"ftol": cfg.optz_tol_obj, "eps": cfg.optz_tol_x,
               "maxiter": cfg.optz_iter_max, "disp": False}
    box = Bounds(bounds.box_lb, bounds.box_ub, keep_feasible=True)

    n_optz = x0_all.shape[0]
    sols = np.full((n_optz, info.n_hp), np.nan)
    objs = np.full(n_optz, np.nan)
    conds = np.full(n_optz, np.nan)
    success = np.zeros(n_optz, bool)
    iters = np.zeros(n_optz)
    con_good = np.zeros(n_optz, bool)

    for i in range(n_optz):
        memo.last_x = None
        res = minimize(memo.obj_val, x0_all[i], method=method,
                       jac=memo.obj_grad, bounds=box, constraints=constraints,
                       options=opt)
        sols[i] = res.x
        objs[i] = res.fun
        success[i] = res.success
        iters[i] = res.nit
        if use_cstr:
            conds[i] = memo.cond(res.x)
            con_good[i] = conds[i] < 1.01 * cfg.cond_max
        else:
            con_good[i] = True

    pool = np.where(con_good)[0] if con_good.any() else np.arange(n_optz)
    best = pool[np.nanargmin(objs[pool])]
    lkd = lkd_cond_at(cfg, spec, info, data, eta_const, sols[best])
    tele = {
        "hp_optz_success": float(success.mean()),
        "hp_optz_iter_mean": float(iters.mean()),
        "hp_optz_iter_max": float(iters.max()),
        "hp_optz_con_good": float(con_good.mean()),
        "optz_n_cho_fail": int(memo.n_cho_fail),
        "optz_n_val": int(memo.n_val),
        "optz_n_grad": int(memo.n_grad),
        "optz_n_cond": int(memo.n_cond),
        "optz_n_cond_grad": int(memo.n_cond_grad),
        "optz_n_cond2big": int(np.sum(conds > cfg.cond_max)) if use_cstr else 0,
        "optz_max_init_cond": float("nan"),
    }
    return FitResult(hp_vec=sols[best], neg_lkd=float(objs[best]),
                     cond=float(lkd.cond), info=tele)
