"""Gradient-enhanced Bayesian-optimization loop (counterpart of
``gpgradpy_tpu/bo/loop.py``).

Initial LHS design -> fit the GP (``set_hpara("optz", i)``: K1/K2 on the
card) -> multistart gradient-based acquisition optimization -> evaluate ->
append, with result traces written in the npz schema of the JAX package
(merit_all / opt_all / fsb_all (+_wo_noise), shape (n_starts, n_iter)).

The JAX package runs the acquisition L-BFGS of all starts as one vmapped
XLA program.  Here the port's ``fit/lbfgs.lbfgs_box_multistart`` steps the
starts on the host and hands the objective the rows of every start that
needs a value at once: one batched ``predict.eval_model`` call on the
model's device and one copy back per call.  Every GP (the global one and
the exploit phase's local one) lives on the device named by
``gp_options["device"]`` ("cuda" unless the caller asks for "cpu").
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..api import GaussianProcess
from ..fit import lbfgs, lhs
from ..model import predict
from . import acquisition


class BoTrace(NamedTuple):
    x_all: np.ndarray        # (n_iter, dim) evaluated points
    merit_all: np.ndarray    # (n_iter,) objective values
    opt_all: np.ndarray      # (n_iter,) ||grad f||_2 (optimality)
    fsb_all: np.ndarray      # (n_iter,) feasibility (1.0 = feasible)
    time_iter: np.ndarray


def acq_objective(gp: GaussianProcess, acq: str, beta: float, fval_best):
    """The acquisition as ``lbfgs_box_multistart``'s objective: rows X (b,
    dim) of the working frame -> (acq (b,), dacq/dx (b, dim), zeros (b,)) as
    numpy, from one ``eval_model`` of all b rows on the model's device, at
    the facade's predict config and precision (f64 under the polish)."""
    cfg, spec, data, state = gp.cfg_predict, gp.spec, gp.data, gp._eval_state
    dtype, device = gp._predict_dtype, gp.device

    def fun(X):
        xq = torch.as_tensor(X, dtype=dtype, device=device)
        with torch.no_grad():
            mu, sig, dmu, dsig, _, _ = predict.eval_model(
                cfg, spec, data, state, xq, calc_grad=True)
            if acq == "ucb":
                a, da = acquisition.ucb(mu, sig, dmu, dsig, beta=beta)
            elif acq == "mu":
                # pure exploitation: minimize the posterior mean
                a, da = mu, dmu
            else:
                a, da = acquisition.expected_improvement(
                    mu, sig, fval_best, dmu, dsig)
            out = torch.cat([a[:, None], da], dim=1).cpu().numpy()
        return out[:, 0], out[:, 1:], np.zeros(out.shape[0], out.dtype)

    return fun


def acq_starts(gp: GaussianProcess, lb_s, ub_s, n_acq_x0: int, seed: int):
    """The acquisition's starts in the working frame: n_acq_x0 LHS points
    and the best data point (of the working frame's values, padding
    included, as in the JAX package)."""
    x0 = lhs.lhs_sample(n_acq_x0, lb_s, ub_s, seed=seed)
    i_best = int(np.argmin(gp.data.fval.cpu().numpy()))
    return np.vstack([x0, gp.data.x[i_best].cpu().numpy()[None, :]])


def propose_next(gp: GaussianProcess, lb, ub, fval_best,
                 acq: str = "ei", beta: float = 2.0,
                 n_acq_x0: int = 16, acq_iter_max: int = 100,
                 seed: int = 0) -> np.ndarray:
    """Optimize the acquisition over the box [lb, ub] with multistart
    gradient-based L-BFGS; returns the proposed point (init frame)."""
    lb = np.asarray(lb, float)
    ub = np.asarray(ub, float)
    # work in the scaled frame if rescaling is active
    if gp.DataScl is not None:
        lb_s, ub_s = gp.DataScl.boxcon_init_2_scl(lb, ub)
        fb = gp.DataScl.obj_init_2_scl(fval_best)[0]
    else:
        lb_s, ub_s, fb = lb, ub, fval_best

    x0 = acq_starts(gp, lb_s, ub_s, n_acq_x0, seed)
    dt = np.float64 if gp._predict_dtype == torch.float64 else np.float32
    # tight tolerances: the exploitation cascade needs x resolved far
    # below the default 1e-8 projected-gradient cut
    res = lbfgs.lbfgs_box_multistart(
        acq_objective(gp, acq, beta, float(fb)), x0.astype(dt),
        lb_s.astype(dt), ub_s.astype(dt), max_iter=acq_iter_max,
        tol_g=1e-14, tol_f=1e-16)
    fvals = np.array(res.f, copy=True)
    fvals[~np.isfinite(fvals)] = np.inf
    x_new_s = res.x[int(np.argmin(fvals))].astype(float)

    if acq == "mu":
        # Newton polish on the posterior mean using the surrogate Hessian:
        # quadratic contraction onto the surrogate minimizer
        xk = x_new_s.copy()
        for _ in range(4):
            _, _, dmu, _, d2mu, _ = gp.eval_model(xk[None, :],
                                                  calc_grad=True,
                                                  calc_hess=True)
            gvec = np.asarray(dmu[0], float)
            H = np.asarray(d2mu[0], float)
            try:
                w, Q = np.linalg.eigh(H)
            except np.linalg.LinAlgError:
                break
            if not np.all(np.isfinite(w)):
                break
            w = np.maximum(np.abs(w), 1e-12 * max(np.max(np.abs(w)), 1e-30))
            step = Q @ ((Q.T @ gvec) / w)
            x_try = np.clip(xk - step, lb_s, ub_s)
            mu_try = gp.eval_model(x_try[None, :])[0][0]
            mu_cur = gp.eval_model(xk[None, :])[0][0]
            if not np.isfinite(mu_try) or mu_try >= mu_cur:
                break
            xk = x_try
        x_new_s = xk

    if gp.DataScl is not None:
        x_new_s = gp.DataScl.x_scl_2_init(x_new_s)
    return np.clip(x_new_s, lb, ub)


_TR_FLOOR_REL = 4e-16       # trust-region radius floor, relative to diameter


def _propose_local_exploit(x_data, f_data, g_data, lb, ub,
                           kernel_type: str, n_local: int, dtype: str,
                           state: dict, newton_steps: int = 8,
                           debug: dict = None,
                           wellcond_mtd: str = "precon",
                           gp_opts: Optional[dict] = None):
    """Surrogate trust-region exploitation (loop.py:129-259 of the JAX
    package).

    Fits a fresh local gradient-enhanced GP on the n_local points nearest
    the incumbent, in an incumbent-centered frame scaled to the cluster
    radius, and minimizes its posterior mean with damped Newton, the total
    step clipped to the persistent trust-region radius ``state['delta']``
    (``run_bo`` expands it on improvement of the truth and shrinks it below
    the attempted step on failure).  Acceptance inside the Newton loop is on
    predicted-mean decrease only.  Where Newton moves less than the radius
    floor, a damped gradient step from the incumbent is taken instead.
    ``gp_opts`` go to the local GP (its device among them)."""
    dim = x_data.shape[1]
    i_inc = int(np.argmin(f_data))
    x_inc = x_data[i_inc]
    g_inc = g_data[i_inc]
    d2 = np.sum((x_data - x_inc) ** 2, axis=1)
    idx = np.argsort(d2)[:n_local]
    xs, fs, gs = x_data[idx], f_data[idx], g_data[idx]
    r_loc = max(float(np.sqrt(d2[idx].max())), 1e-300)

    diam = float(np.linalg.norm(ub - lb))
    delta = state.get("delta")
    if state.get("x_inc") is None or \
            not np.array_equal(state.get("x_inc"), x_inc):
        delta = None                # incumbent moved: re-anchor the radius
    if delta is None:
        delta = min(r_loc, 0.05 * diam)
    delta = float(np.clip(delta, _TR_FLOOR_REL * diam, 0.25 * diam))
    state["x_inc"] = x_inc.copy()
    state["delta"] = delta

    if debug is not None:
        debug.update(r_loc=r_loc, delta=delta, branch="newton",
                     n_accept=0, step_norm=0.0)

    # incumbent frame: center on the incumbent, scale to the cluster radius
    scale = r_loc
    xs_loc = (xs - x_inc) / scale
    gs_loc = gs * scale                      # chain rule for the gradients

    gp = GaussianProcess(dim, True, kernel_type, wellcond_mtd, dtype=dtype,
                         **(gp_opts or {}))
    gp.set_data(xs_loc, fs, np.zeros(len(idx)), gs_loc,
                np.zeros((len(idx), dim)))
    gp.init_optz_surr(1)
    # warm-start from the previous exploit iteration's converged local hp
    # (the incumbent frame normalizes the cluster radius to ~1, so theta is
    # comparable across iterations)
    hp_warm = state.get("hp_local")
    if hp_warm is not None:
        gp.hp_vals = hp_warm
    gp.set_hpara("optz", 0)
    state["hp_local"] = gp.hp_vals

    xk = np.zeros(dim)
    mu_cur = float(gp.eval_model(xk[None, :])[0][0])
    lb_loc = (lb - x_inc) / scale
    ub_loc = (ub - x_inc) / scale
    delta_loc = delta / scale
    for _ in range(newton_steps):
        _, _, dmu, _, d2mu, _ = gp.eval_model(xk[None, :], calc_grad=True,
                                              calc_hess=True)
        gvec = np.asarray(dmu[0], float)
        H = np.asarray(d2mu[0], float)
        try:
            w, Q = np.linalg.eigh(H)
        except np.linalg.LinAlgError:
            break
        if not np.all(np.isfinite(w)):
            break
        w = np.maximum(np.abs(w), 1e-12 * max(np.max(np.abs(w)), 1e-300))
        step = Q @ ((Q.T @ gvec) / w)
        if not np.all(np.isfinite(step)):
            break
        # damped Newton with the TOTAL displacement clipped to the trust
        # region
        accepted = False
        for t in (1.0, 0.5, 0.25, 0.125):
            x_try = np.clip(xk - t * step, lb_loc, ub_loc)
            tot = np.linalg.norm(x_try)
            if tot > delta_loc:
                x_try = x_try * (delta_loc / tot)
            mu_try = float(gp.eval_model(x_try[None, :])[0][0])
            if np.isfinite(mu_try) and mu_try < mu_cur:
                xk, mu_cur = x_try, mu_try
                accepted = True
                if debug is not None:
                    debug["n_accept"] += 1
                break
        if not accepted:
            break

    if np.linalg.norm(xk) * scale < _TR_FLOOR_REL * diam:
        # Newton produced nothing: a damped gradient step from the
        # incumbent, which descends once the trust region is small enough
        if debug is not None:
            debug["branch"] = "grad_step"
        gn = np.linalg.norm(g_inc)
        if gn > 0 and np.all(np.isfinite(g_inc)):
            xk = -(0.5 * delta / scale) * g_inc / gn

    if debug is not None:
        debug["step_norm"] = float(np.linalg.norm(xk) * scale)
    x_new = x_inc + xk * scale
    return np.clip(x_new, lb, ub)


def run_bo(obj_fun: Callable, lb, ub, n_iter: int,
           dim: Optional[int] = None, n_init: int = 5,
           kernel_type: str = "SqExp", wellcond_mtd: str = "precon",
           use_grad: bool = True, acq: str = "ei", beta: float = 2.0,
           exploit_frac: float = 0.0, exploit_local: bool = False,
           noise_std: float = 0.0, seed: int = 0,
           gp_options: Optional[dict] = None, verbose: bool = False,
           checkpoint_cb: Optional[Callable] = None,
           checkpoint_every: int = 10,
           exploit_wellcond: Optional[str] = "precon",
           resume_trace: Optional[BoTrace] = None) -> BoTrace:
    """One BO run (loop.py:262-492 of the JAX package).  ``obj_fun(x) ->
    (f, grad)`` with x of shape (m, dim).

    Per iteration: GP.set_data -> set_hpara('optz', i) -> propose_next ->
    evaluate truth -> append.  In the final ``exploit_frac`` of the
    iterations the acquisition becomes the posterior mean, or with
    ``exploit_local`` (gradients, no noise) the trust-region exploit of
    ``_propose_local_exploit``, which skips the global refit.

    ``gp_options`` go to the global GP (``device`` among them: "cuda" by
    default, "cpu" on request); the local exploit GP takes ``cond_norm``
    and ``device`` from them and runs ``exploit_wellcond`` (None: the
    global method).  Unlike the JAX package, no ``pad_n_eval_multiple``
    is set by default: torch compiles no program per shape.

    ``resume_trace``: a partial BoTrace (e.g. a periodic checkpoint) whose
    finite-merit prefix is replayed instead of re-run: the recorded points
    are re-evaluated through ``obj_fun`` (noise-free objectives only) and
    checked against the recorded merits, and the loop continues from the
    first un-run iteration.  The exploit trust-region state and the
    proposal rng streams restart at the resume point.

    ``time_iter`` is the host wall time of each iteration, through the
    proposal's copy to the host and the truth evaluation."""
    lb = np.asarray(lb, float)
    ub = np.asarray(ub, float)
    dim = lb.size if dim is None else dim
    rng = np.random.default_rng(seed)

    x_data = lhs.lhs_sample(n_init, lb, ub, seed=seed)
    f_data, g_data = obj_fun(x_data)
    if noise_std > 0:
        f_data = f_data + noise_std * rng.standard_normal(f_data.shape)
        g_data = g_data + noise_std * rng.standard_normal(g_data.shape)

    gp_options = dict(gp_options or {})
    gp = GaussianProcess(dim, use_grad, kernel_type, wellcond_mtd,
                         **gp_options)
    gp.init_optz_surr(n_iter + 1)

    n_total = n_init + n_iter
    x_all = np.full((n_total, dim), np.nan)
    merit = np.full(n_total, np.nan)
    opt = np.full(n_total, np.nan)
    fsb = np.ones(n_total)
    t_iter = np.full(n_total, np.nan)
    x_all[:n_init] = x_data
    merit[:n_init] = f_data
    opt[:n_init] = np.linalg.norm(g_data, axis=1)

    std_f = np.full(n_init, noise_std) if noise_std > 0 else np.zeros(n_init)
    std_g = (np.full((n_init, dim), noise_std) if noise_std > 0
             else np.zeros((n_init, dim)))

    i_start = 0
    if resume_trace is not None:
        # explicit raises (not asserts): resume validation must survive
        # python -O
        if noise_std != 0:
            raise ValueError(
                "resume_trace needs a deterministic (noise-free) objective")
        m_prev = np.asarray(resume_trace.merit_all, float)
        fin = np.isfinite(m_prev)
        n_done = int(fin.sum())
        if not fin[:n_done].all():
            raise ValueError(
                "resume_trace: finite-merit prefix is not contiguous")
        if n_done > n_init and m_prev.size == n_total:
            x_prev = np.asarray(resume_trace.x_all, float)[:n_done]
            f_prev, g_prev = obj_fun(x_prev)
            if not np.allclose(f_prev, m_prev[:n_done], rtol=1e-10,
                               atol=1e-300):
                raise ValueError(
                    "resume_trace merits do not match obj_fun at the "
                    "recorded points -- wrong objective or noisy truth")
            x_data, f_data, g_data = x_prev, f_prev, g_prev
            x_all[:n_done] = x_prev
            merit[:n_done] = m_prev[:n_done]
            opt[:n_done] = np.asarray(resume_trace.opt_all)[:n_done]
            fsb[:n_done] = np.asarray(resume_trace.fsb_all)[:n_done]
            t_iter[:n_done] = np.asarray(resume_trace.time_iter)[:n_done]
            std_f = np.zeros(n_done)
            std_g = np.zeros((n_done, dim))
            i_start = n_done - n_init

    exploit_state = {}
    diam = float(np.linalg.norm(ub - lb))
    rng_tr = np.random.default_rng(seed + 424243)
    # the local exploit GP keeps the numerics-relevant options and the
    # device, not the shape bucketing (the local cluster has its own size)
    local_opts = {k: v for k, v in gp_options.items()
                  if k in ("cond_norm", "device")}
    for i in range(i_start, n_iter):
        t0 = time.time()
        fbest = float(np.min(f_data))
        # final exploitation phase: switch to minimizing the posterior mean
        in_exploit = exploit_frac > 0 and i >= (1.0 - exploit_frac) * n_iter
        dbg = {} if verbose else None
        exploit_fired = (in_exploit and exploit_local and use_grad
                         and noise_std == 0)
        if not exploit_fired:
            # the local-exploit proposal never touches the global surrogate,
            # so its refit is skipped during the exploit phase
            gp.set_data(x_data, f_data, std_f,
                        g_data if use_grad else None,
                        std_g if use_grad else None)
            gp.set_hpara("optz", i)
        if exploit_fired:
            # smallest cluster with enough data for a quadratic-accurate
            # local model: m(1+d) >= (d+1)(d+2)/2 plus slack
            n_loc = max(4, (dim + 3) // 2 + 2)
            x_new = _propose_local_exploit(
                x_data, f_data, g_data, lb, ub, kernel_type,
                n_local=min(x_data.shape[0], n_loc),
                dtype=gp_options.get("dtype", "float64"),
                state=exploit_state, debug=dbg,
                wellcond_mtd=(wellcond_mtd if exploit_wellcond is None
                              else exploit_wellcond),
                gp_opts=local_opts)
        else:
            acq_i = "mu" if in_exploit else acq
            x_new = propose_next(gp, lb, ub, fbest, acq=acq_i, beta=beta,
                                 seed=seed + i)
        # duplicate guard: a proposal (numerically) identical to an existing
        # datum adds no information.  From the exploit phase with the trust
        # region at its floor the run has converged to machine precision:
        # stop and leave the NaN tail.  With the radius still large: shrink
        # it and spend the evaluation on a ball sample inside the trust
        # region.  From the explore phase: propose again with another seed.
        dmin = float(np.min(np.linalg.norm(x_data - x_new[None, :], axis=1)))
        if dmin < _TR_FLOOR_REL * diam:
            if exploit_fired:
                delta = exploit_state.get("delta", diam)
                if delta <= 4.0 * _TR_FLOOR_REL * diam:
                    if verbose:
                        print(f"BO iter {i}: exploit cascade at machine-"
                              f"precision floor (dmin={dmin:.1e}); stopping",
                              flush=True)
                    break
                exploit_state["delta"] = delta / 4.0
                u = rng_tr.standard_normal(dim)
                u = u / max(np.linalg.norm(u), 1e-300)
                x_new = np.clip(exploit_state["x_inc"] + 0.5 * delta * u,
                                lb, ub)
            else:
                x_new = propose_next(gp, lb, ub, fbest, acq=acq, beta=beta,
                                     seed=seed + 7919 * (i + 1))
        f_new, g_new = obj_fun(x_new[None, :])
        if exploit_fired:
            # classic trust-region update on the TRUTH: expand on
            # improvement over the incumbent, shrink below the attempted
            # step on failure
            step_len = float(np.linalg.norm(x_new - exploit_state["x_inc"]))
            if f_new[0] < fbest:
                exploit_state["delta"] = min(
                    max(exploit_state["delta"], 4.0 * step_len), 0.25 * diam)
            else:
                exploit_state["delta"] = max(step_len / 4.0,
                                             _TR_FLOOR_REL * diam)
        if noise_std > 0:
            f_new = f_new + noise_std * rng.standard_normal(1)
            g_new = g_new + noise_std * rng.standard_normal((1, dim))

        k = n_init + i
        x_all[k] = x_new
        merit[k] = f_new[0]
        opt[k] = np.linalg.norm(g_new[0])
        t_iter[k] = time.time() - t0
        if verbose:
            extra = ""
            if dbg:
                extra = (f", exploit[{dbg['branch']}] r_loc={dbg['r_loc']:.2e}"
                         f" acc={dbg['n_accept']} step={dbg['step_norm']:.2e}")
            print(f"BO iter {i}: f = {f_new[0]:.4e}, "
                  f"|grad| = {opt[k]:.3e}, best = {min(fbest, f_new[0]):.4e}"
                  + extra, flush=True)

        x_data = np.vstack([x_data, x_new[None, :]])
        f_data = np.concatenate([f_data, f_new])
        g_data = np.vstack([g_data, g_new])
        std_f = np.concatenate([std_f, [noise_std if noise_std > 0 else 0.0]])
        std_g = np.vstack([std_g, np.full((1, dim),
                                          noise_std if noise_std > 0 else 0.0)])

        # periodic checkpoint: un-run iterations stay NaN in the partial
        # trace
        if checkpoint_cb is not None and (i + 1) % checkpoint_every == 0:
            checkpoint_cb(BoTrace(x_all=x_all.copy(), merit_all=merit.copy(),
                                  opt_all=opt.copy(), fsb_all=fsb.copy(),
                                  time_iter=t_iter.copy()))

    return BoTrace(x_all=x_all, merit_all=merit, opt_all=opt, fsb_all=fsb,
                   time_iter=t_iter)


def constrained_score(gp_obj: GaussianProcess, gp_con, cand, fbest):
    """EI x prod_i P(c_i <= 0) at the candidates (n, dim), init frame;
    numpy (n,)."""
    mu, sig = gp_obj.eval_model(cand)[:2]
    ei, _ = acquisition.expected_improvement(torch.as_tensor(mu),
                                             torch.as_tensor(sig), fbest)
    score = -ei.numpy()
    for gp in gp_con:
        muc, sigc = (torch.as_tensor(v) for v in gp.eval_model(cand)[:2])
        pof = torch.special.ndtr((0.0 - muc) / torch.clamp_min(sigc, 1e-12))
        score = score * pof.numpy()
    return score


def run_bo_constrained(obj_fun: Callable, con_funs, lb, ub, n_iter: int,
                       dim: Optional[int] = None, n_init: int = 8,
                       kernel_type: str = "SqExp",
                       wellcond_mtd: str = "precon", use_grad: bool = True,
                       seed: int = 0, verbose: bool = False,
                       gp_options: Optional[dict] = None) -> BoTrace:
    """Constrained BO (loop.py:495-601 of the JAX package): one GP per
    constraint (feasible iff c_i(x) <= 0) next to the objective GP,
    acquisition = EI x prod_i P(c_i <= 0) over 64 LHS candidates and the
    best feasible point.  ``con_funs``: list of callables x -> (c, grad_c)
    like obj_fun.  ``gp_options`` go to every GP (``device`` among them);
    the JAX package hardwires its GPs' options."""
    lb = np.asarray(lb, float)
    ub = np.asarray(ub, float)
    dim = lb.size if dim is None else dim
    n_con = len(con_funs)

    x_data = lhs.lhs_sample(n_init, lb, ub, seed=seed)
    f_data, g_data = obj_fun(x_data)
    c_data = []
    cg_data = []
    for cf in con_funs:
        c, cg = cf(x_data)
        c_data.append(c)
        cg_data.append(cg)

    def make_gp(name):
        gp = GaussianProcess(dim, use_grad, kernel_type, wellcond_mtd,
                             surr_name=name, **(gp_options or {}))
        gp.init_optz_surr(n_iter + 1)
        return gp

    gp_obj = make_gp("obj_")
    gp_con = [make_gp(f"con{i}_") for i in range(n_con)]

    n_total = n_init + n_iter
    x_all = np.full((n_total, dim), np.nan)
    merit = np.full(n_total, np.nan)
    opt = np.full(n_total, np.nan)
    fsb = np.full(n_total, np.nan)
    x_all[:n_init] = x_data
    merit[:n_init] = f_data
    opt[:n_init] = np.linalg.norm(g_data, axis=1)
    fsb[:n_init] = np.all(np.stack(c_data, 1) <= 0, axis=1) if n_con else 1.0

    for i in range(n_iter):
        n = x_data.shape[0]
        zeros = np.zeros(n)
        zg = np.zeros((n, dim))
        gp_obj.set_data(x_data, f_data, zeros, g_data if use_grad else None,
                        zg if use_grad else None)
        gp_obj.set_hpara("optz", i)
        for k in range(n_con):
            gp_con[k].set_data(x_data, c_data[k], zeros,
                               cg_data[k] if use_grad else None,
                               zg if use_grad else None)
            gp_con[k].set_hpara("optz", i)

        feas_mask = (np.all(np.stack(c_data, 1) <= 0, axis=1)
                     if n_con else np.ones(n, bool))
        fbest = (float(np.min(f_data[feas_mask])) if feas_mask.any()
                 else float(np.min(f_data)))

        cand = lhs.lhs_sample(64, lb, ub, seed=seed + i)
        if feas_mask.any():
            cand = np.vstack([cand, x_data[feas_mask][
                np.argmin(f_data[feas_mask])][None, :]])
        score = constrained_score(gp_obj, gp_con, cand, fbest)
        x_new = cand[int(np.argmax(score))]

        f_new, g_new = obj_fun(x_new[None, :])
        c_new = []
        for k, cf in enumerate(con_funs):
            cv, cg = cf(x_new[None, :])
            c_data[k] = np.concatenate([c_data[k], cv])
            cg_data[k] = np.vstack([cg_data[k], cg])
            c_new.append(cv[0])

        j = n_init + i
        x_all[j] = x_new
        merit[j] = f_new[0]
        opt[j] = np.linalg.norm(g_new[0])
        fsb[j] = float(all(c <= 0 for c in c_new)) if n_con else 1.0
        if verbose:
            print(f"cBO iter {i}: f = {f_new[0]:.4e}, feas = {fsb[j]:.0f}, "
                  f"best feas = {fbest:.4e}")

        x_data = np.vstack([x_data, x_new[None, :]])
        f_data = np.concatenate([f_data, f_new])
        g_data = np.vstack([g_data, g_new])

    return BoTrace(x_all=x_all, merit_all=merit, opt_all=opt, fsb_all=fsb,
                   time_iter=np.full(n_total, np.nan))


def run_bo_multistart(obj_fun: Callable, lb, ub, n_iter: int, n_x0: int = 5,
                      save_path: Optional[str] = None, seed0: int = 0,
                      obj_fun_wo_noise: Optional[Callable] = None,
                      **bo_kw) -> dict:
    """n_x0 independent BO runs; writes the PltOptzResults npz schema
    (x0_all (n_x0, n_iter, dim), merit_all / opt_all / fsb_all (+_wo_noise)
    of shape (n_x0, n_iter)).  The npz is (re)written after every completed
    start and at every checkpoint, so long runs can be harvested early."""
    traces = []
    for j in range(n_x0):
        cb = None
        if save_path is not None:
            def cb(partial_trace):
                np.savez(save_path, **_traces_to_dict(
                    traces + [partial_trace], obj_fun_wo_noise))
        traces.append(run_bo(obj_fun, lb, ub, n_iter, seed=seed0 + j,
                             checkpoint_cb=cb, **bo_kw))
        if save_path is not None and j + 1 < n_x0:
            partial = _traces_to_dict(traces, obj_fun_wo_noise)
            np.savez(save_path, **partial)
    out = _traces_to_dict(traces, obj_fun_wo_noise)
    if save_path is not None:
        np.savez(save_path, **out)
    return out


def _traces_to_dict(traces, obj_fun_wo_noise=None) -> dict:
    n_x0 = len(traces)
    n_total = traces[0].merit_all.size
    out = {
        "x0_all": np.stack([t.x_all for t in traces]),
        "merit_all": np.stack([t.merit_all for t in traces]),
        "opt_all": np.stack([t.opt_all for t in traces]),
        "fsb_all": np.stack([t.fsb_all for t in traces]),
    }
    if obj_fun_wo_noise is not None:
        merit_wo = np.full((n_x0, n_total), np.nan)
        opt_wo = np.full((n_x0, n_total), np.nan)
        for j, t in enumerate(traces):
            f, g = obj_fun_wo_noise(t.x_all)
            merit_wo[j] = f
            opt_wo[j] = np.linalg.norm(g, axis=1)
        out["merit_wo_noise_all"] = merit_wo
        out["opt_wo_noise_all"] = opt_wo
        out["fsb_wo_noise_all"] = out["fsb_all"]
    else:
        out["merit_wo_noise_all"] = out["merit_all"]
        out["opt_wo_noise_all"] = out["opt_all"]
        out["fsb_wo_noise_all"] = out["fsb_all"]
    return out
