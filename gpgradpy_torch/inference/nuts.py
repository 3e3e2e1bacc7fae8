"""No-U-Turn Sampler over GP hyperparameters, batched over chains
(counterpart of ``gpgradpy_tpu/inference/nuts.py``).

Iterative NUTS (Hoffman & Gelman 2014, with the iterative tree construction
and multinomial proposal sampling of Phan et al. 2019) and windowed warmup:
dual-averaging step size and a diagonal mass matrix (Welford), per chain or
averaged across chains.

The JAX package runs each chain's tree as a ``while_loop`` under ``vmap``.
Here the chain axis is the leading axis of every tensor and the chains
step in lockstep: the doubling loop (up to ``max_depth``) and the leaf loop
(``2^depth`` leaves) run on the host with a per-chain ``active`` mask.
Within a subtree the leaf index and the depth are the same for every chain,
so the checkpoint U-turn test runs over a host range of checkpoints.  Each
leaf evaluates the log-density at the active chains only (gathered rows, one
batched value + gradient call, scattered back), so a chain that has stopped
costs no evaluation; each leaf reads one mask from the device.  A chain's
transition is that of the JAX lane with the same draws.

Every random draw comes from a ``Draws`` object (draws.py), carried in
``NutsState.rng`` as the JAX state carries its key.  Each site is handed
the host mask of the chains that consume its draw, so that each chain
draws from its own stream and its transitions do not depend on the other
chains.

The target is any batched log-density ``z (B, n) -> (B,)``; for GP
hyperparameter posteriors use ``make_gp_logpost`` (MLL + box-uniform prior
through a logit reparameterization, so the chain lives in R^n).
"""

from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import GpConfig
from ..model import likelihood
from ..types import DataSpec, GpData, HpInfo
from .draws import Draws


# ---------------------------------------------------------------------------
# Target construction
# ---------------------------------------------------------------------------

def make_gp_logpost(cfg: GpConfig, spec: DataSpec, info: HpInfo, data: GpData,
                    eta_const, lb, ub):
    """Log posterior over an unconstrained z of shape (n_hp,) or (B, n_hp),
    with hp_vec = lb + (ub - lb) * sigmoid(z) and the log-Jacobian of the
    transform (box-uniform prior on the optimization-space hp vector).
    Differentiable in z; every row goes through one batched ``neg_mll``
    (K1 forward, K2 in the backward on the card).  Where a Cholesky fails,
    neg_mll's restoring fallback (1e12 scale) passes through."""
    # pin the bounds to the model dtype and device: f64 numpy bounds would
    # otherwise promote an f32 model's MLL
    lb = torch.as_tensor(lb, dtype=data.x.dtype, device=data.x.device)
    ub = torch.as_tensor(ub, dtype=data.x.dtype, device=data.x.device)

    def logpost(z):
        s = torch.sigmoid(z)
        hp_vec = lb + (ub - lb) * s
        log_jac = (torch.log(ub - lb) + torch.log(s)
                   + torch.log1p(-s)).sum(-1)
        val, _ = likelihood.neg_mll(cfg, spec, info, data, hp_vec, eta_const)
        return -val + log_jac

    def z_to_hp(z):
        return lb + (ub - lb) * torch.sigmoid(z)

    def hp_to_z(hp_vec):
        u = torch.clamp((hp_vec - lb) / (ub - lb), 1e-6, 1 - 1e-6)
        return torch.log(u) - torch.log1p(-u)

    return logpost, z_to_hp, hp_to_z


def value_and_grad(logp_fn: Callable) -> Callable:
    """z (B, n) -> (logp (B,), d logp / dz (B, n)), with a non-finite logp
    mapped to -inf and a non-finite gradient entry to 0 (nuts.py:340-344 of
    the JAX package).  The rows must be independent."""
    def lg(z):
        zr = z.detach().requires_grad_(True)
        with torch.enable_grad():
            v = logp_fn(zr)
            g, = torch.autograd.grad(v.sum(), zr)
        v = v.detach()
        v = torch.where(torch.isfinite(v), v, torch.full_like(v, -math.inf))
        g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
        return v, g
    return lg


# ---------------------------------------------------------------------------
# Leapfrog and tree machinery (per chain: a leading chain axis everywhere)
# ---------------------------------------------------------------------------

def _leapfrog(logp_and_grad, inv_mass, step, z, r, grad):
    """One leapfrog step of every row; step is (B,) (signed)."""
    step = step[:, None]
    r = r + 0.5 * step * grad
    z = z + step * inv_mass * r
    logp, grad = logp_and_grad(z)
    r = r + 0.5 * step * grad
    return z, r, grad, logp


def _kinetic(inv_mass, r):
    return 0.5 * (inv_mass * r * r).sum(-1)


def _is_turning(inv_mass, r_left, r_right, z_sum):
    """Generalized U-turn criterion on the momentum sum (Betancourt 2017),
    over the last axis."""
    v = inv_mass * z_sum
    return ((v * r_left).sum(-1) <= 0) | ((v * r_right).sum(-1) <= 0)


def _popcount(i: int) -> int:
    return bin(i).count("1")


def _trailing_ones(i: int) -> int:
    # i ^ (i+1) has bits set at all trailing ones plus the next zero bit
    return _popcount(i ^ (i + 1)) - 1


class NutsState(NamedTuple):
    z: torch.Tensor              # (B, n)
    logp: torch.Tensor           # (B,)
    grad: torch.Tensor           # (B, n)
    step: torch.Tensor           # (B,)
    inv_mass: torch.Tensor       # (B, n)
    rng: Draws                   # the draw streams, one per chain
    accept_prob: torch.Tensor    # (B,) mean accept prob of last trajectory
    diverging: torch.Tensor      # (B,) bool
    n_leapfrog: torch.Tensor     # (B,) int


_DELTA_MAX = 1000.0


def _where(mask, a, b):
    """torch.where with a (B,) mask over rows of (B, ...) tensors."""
    return torch.where(mask.view(-1, *([1] * (a.ndim - 1))), a, b)


def _build_subtree(lg, draws, inv_mass, step, energy0, active, active_h,
                   going_right, z, r, grad, logp0, n_leaves: int,
                   max_depth: int):
    """Add up to ``n_leaves`` leaves to the edge (z, r, grad) of every
    active chain, in lockstep; a chain stops at its first U-turn or
    divergence, as its lane's while_loop does in the JAX package
    (nuts.py:137-213 there).  ``active_h`` is ``active`` on the host."""
    B, n = z.shape
    dt = z.dtype
    direction = torch.where(going_right, 1.0, -1.0).to(dt)
    ckpt_r = torch.zeros((max_depth + 1, B, n), dtype=dt, device=z.device)
    ckpt_rsum = torch.zeros_like(ckpt_r)
    z, r, grad = z.clone(), r.clone(), grad.clone()
    logp = torch.zeros_like(logp0)
    z_prop, logp_prop, grad_prop = (z.clone(), torch.zeros_like(logp0),
                                    grad.clone())
    log_w = torch.full((B,), -math.inf, dtype=dt, device=z.device)
    r_sum = torch.zeros_like(r)
    sum_acc = torch.zeros((B,), dtype=dt, device=z.device)
    turning = torch.zeros_like(active)
    diverging = torch.zeros_like(active)
    live = active
    for i in range(n_leaves):
        # the leaf's one sync (the first leaf's mask is the doubling's)
        live_h = active_h if i == 0 else live.cpu().numpy()
        if not live_h.any():
            break
        idx = torch.as_tensor(np.flatnonzero(live_h), device=z.device)
        u = draws.leaf_uniform(live_h, dt)
        z_a, r_a, g_a, lp_a = _leapfrog(lg, inv_mass[idx],
                                        (direction * step)[idx], z[idx],
                                        r[idx], grad[idx])
        z[idx], r[idx], grad[idx], logp[idx] = z_a, r_a, g_a, lp_a

        energy = -logp + _kinetic(inv_mass, r)
        # the bookkeeping stays in the state dtype (an f32 chain over an
        # f64 log-density)
        delta = (energy - energy0).to(dt)
        div_new = (~torch.isfinite(energy)) | (delta > _DELTA_MAX)
        log_w_leaf = torch.where(div_new, -math.inf, -delta)
        accept = torch.clamp_max(torch.exp(-delta), 1.0)
        accept = torch.where(torch.isfinite(accept), accept, 0.0)

        # multinomial (progressive) proposal within the subtree
        log_w_new = torch.logaddexp(log_w, log_w_leaf)
        take = live & (torch.log(u) < (log_w_leaf - log_w_new))
        z_prop = _where(take, z, z_prop)
        logp_prop = torch.where(take, logp, logp_prop)
        grad_prop = _where(take, grad, grad_prop)
        r_sum = _where(live, r_sum + r, r_sum)

        # checkpoints: even leaves store, odd leaves check the U-turn of
        # every subtree that this leaf closes (a host range of k)
        pc = _popcount(i)
        if i % 2 == 0:
            ckpt_r[pc] = r
            ckpt_rsum[pc] = r_sum - r
        else:
            k0, k1 = pc - _trailing_ones(i), pc   # k in [k0, pc - 1]
            turn_k = _is_turning(inv_mass, ckpt_r[k0:k1], r,
                                 r_sum - ckpt_rsum[k0:k1])
            turning = turning | (live & turn_k.any(0))

        log_w = torch.where(live, log_w_new, log_w)
        sum_acc = sum_acc + torch.where(live, accept, 0.0)
        diverging = diverging | (live & div_new)
        live = live & ~turning & ~diverging
    return (z, r, grad, z_prop, logp_prop, grad_prop, log_w, r_sum, sum_acc,
            turning, diverging)


def nuts_step(logp_and_grad: Callable, state: NutsState,
              max_depth: int = 8) -> NutsState:
    """One NUTS transition of every chain (nuts.py:109-276 of the JAX
    package).  ``logp_and_grad`` maps z (A, n) to ((A,), (A, n)) for any
    subset of A chains."""
    draws = state.rng
    z0, logp0, grad0 = state.z, state.logp, state.grad
    step, inv_mass = state.step, state.inv_mass
    B, n = z0.shape
    dt, dev = z0.dtype, z0.device

    r0 = draws.momentum(B, n, dt) / torch.sqrt(inv_mass)
    energy0 = -logp0 + _kinetic(inv_mass, r0)

    # the initial singleton tree is the current point
    z_left = z_right = z_prop = z0
    r_left = r_right = r_sum = r0
    g_left = g_right = g_prop = grad0
    logp_prop = logp0
    log_weight = torch.zeros(B, dtype=dt, device=dev)
    sum_accept = torch.zeros(B, dtype=dt, device=dev)
    n_leaf = torch.zeros(B, dtype=torch.int64, device=dev)
    turning = torch.zeros(B, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    active = ~turning

    active_h = np.ones(B, bool)
    for depth in range(max_depth):
        if depth:
            active_h = active.cpu().numpy()
            if not active_h.any():
                break
        going_right = draws.direction(active_h)
        z_e = _where(going_right, z_right, z_left)
        r_e = _where(going_right, r_right, r_left)
        g_e = _where(going_right, g_right, g_left)
        (z_e, r_e, g_e, z_prop_n, logp_prop_n, g_prop_n, log_w_n, r_sum_n,
         sum_acc_n, turn_n, div_n) = _build_subtree(
            logp_and_grad, draws, inv_mass, step, energy0, active, active_h,
            going_right, z_e, r_e, g_e, logp0, 2 ** depth, max_depth)

        # biased progressive sampling across the doubling
        u = draws.doubling_uniform(active_h, dt)
        accept_new = torch.exp(torch.clamp_max(log_w_n - log_weight, 0.0))
        take = active & (u < accept_new) & ~turn_n & ~div_n
        z_prop = _where(take, z_prop_n, z_prop)
        logp_prop = torch.where(take, logp_prop_n, logp_prop)
        g_prop = _where(take, g_prop_n, g_prop)

        left = active & ~going_right
        right = active & going_right
        z_left, r_left, g_left = (_where(left, z_e, z_left),
                                  _where(left, r_e, r_left),
                                  _where(left, g_e, g_left))
        z_right, r_right, g_right = (_where(right, z_e, z_right),
                                     _where(right, r_e, r_right),
                                     _where(right, g_e, g_right))
        r_sum = _where(active, r_sum + r_sum_n, r_sum)
        turning = torch.where(
            active, turn_n | _is_turning(inv_mass, r_left, r_right, r_sum),
            turning)
        diverging = torch.where(active, div_n, diverging)
        log_weight = torch.where(active, torch.logaddexp(log_weight, log_w_n),
                                 log_weight)
        sum_accept = sum_accept + torch.where(active, sum_acc_n, 0.0)
        # a doubling counts its 2^depth leaves, also where it stopped early
        # (as in the JAX package)
        n_leaf = n_leaf + torch.where(active, 2 ** depth, 0)
        active = active & ~turning & ~diverging

    accept_prob = sum_accept / torch.clamp_min(n_leaf, 1)
    return NutsState(z=z_prop, logp=logp_prop, grad=g_prop, step=step,
                     inv_mass=inv_mass, rng=draws, accept_prob=accept_prob,
                     diverging=diverging, n_leapfrog=n_leaf)


# ---------------------------------------------------------------------------
# Warmup adaptation (dual averaging + diagonal mass)
# ---------------------------------------------------------------------------

class WarmupState(NamedTuple):
    nuts: NutsState
    log_step_bar: torch.Tensor   # (B,)
    h_bar: torch.Tensor          # (B,)
    mu: torch.Tensor             # (B,)
    welford_mean: torch.Tensor   # (B, n)
    welford_m2: torch.Tensor     # (B, n)
    welford_n: float


def _dual_avg_update(ws: WarmupState, t: float, target_accept=0.8,
                     gamma=0.05, t0=10.0, kappa=0.75,
                     cross_chain_mean=None) -> WarmupState:
    """Nesterov dual averaging on log(step); ``cross_chain_mean`` reduces
    the accept-prob statistic across chains."""
    a = ws.nuts.accept_prob
    if cross_chain_mean is not None:
        a = cross_chain_mean(a)
    h_bar = (1.0 - 1.0 / (t + t0)) * ws.h_bar + (target_accept - a) / (t + t0)
    log_step = ws.mu - math.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_step_bar = eta * log_step + (1 - eta) * ws.log_step_bar
    return ws._replace(nuts=ws.nuts._replace(step=torch.exp(log_step)),
                       log_step_bar=log_step_bar, h_bar=h_bar)


def _welford_update(ws: WarmupState) -> WarmupState:
    """Per-chain Welford accumulation of z."""
    z = ws.nuts.z
    n = ws.welford_n + 1
    delta = z - ws.welford_mean
    mean = ws.welford_mean + delta / n
    m2 = ws.welford_m2 + delta * (z - mean)
    return ws._replace(welford_mean=mean, welford_m2=m2, welford_n=n)


def chain_mean(x: torch.Tensor) -> torch.Tensor:
    """Pooled adaptation on one device: the mean over the chain axis, given
    back to every chain (``cross_chain_mean`` of ``run_nuts``)."""
    return x.mean(0, keepdim=True).expand_as(x)


def _init_state(lg, z0, draws, init_step) -> NutsState:
    B, n = z0.shape
    logp0, grad0 = lg(z0)
    return NutsState(z=z0, logp=logp0, grad=grad0,
                     step=torch.full((B,), init_step, dtype=z0.dtype,
                                     device=z0.device),
                     inv_mass=torch.ones_like(z0), rng=draws,
                     accept_prob=torch.zeros_like(z0[:, 0]),
                     diverging=torch.zeros(B, dtype=torch.bool,
                                           device=z0.device),
                     n_leapfrog=torch.zeros(B, dtype=torch.int64,
                                            device=z0.device))


def run_nuts(logp_fn: Callable, z0: torch.Tensor, draws: Draws,
             n_warmup: int = 500, n_samples: int = 500,
             max_depth: int = 8, target_accept: float = 0.8,
             init_step: float = 0.1, cross_chain_mean=None):
    """Warmup + sampling of the chains z0 (B, n) (or one chain, (n,)) over
    the batched log-density ``logp_fn``.  ``cross_chain_mean`` None adapts
    each chain on its own statistics; a callable (``chain_mean``) pools the
    accept statistic and the mass matrix over the chain axis.

    Returns (samples (B, n_samples, n), diagnostics dict with a leading
    chain axis), the vmapped JAX function's layout; without a chain axis in
    z0 neither has one."""
    single = z0.ndim == 1
    if single:
        z0 = z0[None]
    lg = value_and_grad(logp_fn)
    B, n = z0.shape
    dt, dev = z0.dtype, z0.device
    nuts = _init_state(lg, z0, draws, init_step)
    ws = WarmupState(nuts=nuts,
                     log_step_bar=torch.full((B,), math.log(init_step),
                                             dtype=dt, device=dev),
                     h_bar=torch.zeros(B, dtype=dt, device=dev),
                     mu=torch.full((B,), math.log(10.0 * init_step),
                                   dtype=dt, device=dev),
                     welford_mean=torch.zeros_like(z0),
                     welford_m2=torch.zeros_like(z0), welford_n=0.0)

    mass_update_start = n_warmup // 3
    mass_update_end = (5 * n_warmup) // 6
    for t in range(n_warmup):
        ws = ws._replace(nuts=nuts_step(lg, ws.nuts, max_depth))
        ws = _dual_avg_update(ws, t + 1.0, target_accept,
                              cross_chain_mean=cross_chain_mean)
        if mass_update_start <= t < mass_update_end:
            ws = _welford_update(ws)
        if t == mass_update_end - 1:
            var = ws.welford_m2 / max(ws.welford_n - 1, 1)
            var = torch.where(var > 0, var, 1.0)
            if cross_chain_mean is not None:
                var = cross_chain_mean(var)
            ws = ws._replace(nuts=ws.nuts._replace(inv_mass=var))
    nuts = ws.nuts._replace(step=torch.exp(ws.log_step_bar))

    out = {k: [] for k in ("z", "logp", "accept_prob", "diverging",
                           "n_leapfrog")}
    for _ in range(n_samples):
        nuts = nuts_step(lg, nuts, max_depth)
        for k in out:
            out[k].append(getattr(nuts, k))
    stack = {k: torch.stack(v, 1) if v else
             torch.zeros((B, 0) + getattr(nuts, k).shape[1:],
                         dtype=getattr(nuts, k).dtype, device=dev)
             for k, v in out.items()}
    zs = stack.pop("z")
    diag = dict(stack, step_size=nuts.step, inv_mass=nuts.inv_mass)
    if single:
        zs = zs[0]
        diag = {k: v[0] for k, v in diag.items()}
    return zs, diag


# ---------------------------------------------------------------------------
# Checkpointed long runs
# ---------------------------------------------------------------------------

def save_chain_state(path: str, state: NutsState):
    """Persist a chain-batched NutsState to npz, with the keys of the JAX
    package's file; ``rng`` holds the draws' per-chain counters (uint64,
    chains x sites) and ``rng_seed`` their seed."""
    np.savez(path, z=state.z.cpu().numpy(), logp=state.logp.cpu().numpy(),
             grad=state.grad.cpu().numpy(), step=state.step.cpu().numpy(),
             inv_mass=state.inv_mass.cpu().numpy(),
             rng=state.rng.get_state(), rng_seed=state.rng.seed)


def load_chain_state(path: str, draws: Draws) -> NutsState:
    """Read a chain state saved by ``save_chain_state`` of this package or
    of the JAX package (z, logp, grad, step, inv_mass) onto
    ``draws.device``.  Where the port wrote the file, its seed and per-chain
    counters are loaded into ``draws``, so each chain's stream goes on
    where it stopped.  A file of the JAX package holds JAX keys, which
    torch cannot use: ``draws`` then keeps the streams it was given, so
    seed it explicitly (``Draws(seed)``)."""
    d = np.load(path)
    dev = draws.device

    def t(name):
        return torch.as_tensor(d[name], device=dev)

    if "rng_seed" in d:
        draws.set_state(d["rng"], seed=int(d["rng_seed"]))
    logp = t("logp")
    B = logp.shape[0]
    return NutsState(z=t("z"), logp=logp, grad=t("grad"), step=t("step"),
                     inv_mass=t("inv_mass"), rng=draws,
                     accept_prob=torch.zeros_like(logp),
                     diverging=torch.zeros(B, dtype=torch.bool, device=dev),
                     n_leapfrog=torch.zeros(B, dtype=torch.int64, device=dev))


def run_nuts_checkpointed(logp_fn: Callable, z0: torch.Tensor, draws: Draws,
                          checkpoint_path: str, n_warmup: int = 500,
                          n_samples: int = 500, segment: int = 100,
                          max_depth: int = 8, resume: bool = True, **kw):
    """Multi-chain NUTS in segments with an npz checkpoint after each
    segment; on restart (``resume`` and the checkpoint exists) warmup is
    skipped and sampling continues from the stored chain states (see
    ``load_chain_state`` for the draw stream).  Returns (samples (B,
    n_samples, n) as numpy, the last NutsState)."""
    lg = value_and_grad(logp_fn)
    if resume and os.path.isfile(checkpoint_path):
        state = load_chain_state(checkpoint_path, draws)
    else:
        # warmup once via run_nuts, then rebuild the chain states; the
        # stream goes on (the JAX package folds 17 into each key here)
        zs, diag = run_nuts(logp_fn, z0, draws, n_warmup=n_warmup,
                            n_samples=1, max_depth=max_depth, **kw)
        state = _init_state(lg, zs[:, -1], draws, 0.0)._replace(
            step=diag["step_size"], inv_mass=diag["inv_mass"])
        save_chain_state(checkpoint_path, state)

    all_z = []
    for _ in range(-(-n_samples // segment)):
        seg = []
        for _ in range(segment):
            state = nuts_step(lg, state, max_depth)
            seg.append(state.z)
        all_z.append(torch.stack(seg, 1).cpu().numpy())
        save_chain_state(checkpoint_path, state)
    zs = np.concatenate(all_z, axis=1)[:, :n_samples]
    return zs, state


__all__ = ["Draws", "NutsState", "WarmupState", "make_gp_logpost",
           "value_and_grad", "nuts_step", "run_nuts", "chain_mean",
           "save_chain_state", "load_chain_state", "run_nuts_checkpointed"]
