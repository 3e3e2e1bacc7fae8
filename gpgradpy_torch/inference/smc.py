"""Tempered sequential Monte Carlo over the hyperparameter posterior
(counterpart of ``gpgradpy_tpu/inference/smc.py``).

A fixed temperature ladder, ESS-triggered systematic resampling and
random-walk Metropolis moves; the particle population is the batch axis of
every log-density evaluation.  The whole run is value-only (no autograd), so
on the card each evaluation launches K1 and no K2.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .draws import Draws


class SmcResult(NamedTuple):
    particles: torch.Tensor      # (n_particles, n)
    log_weights: torch.Tensor
    betas: torch.Tensor          # temperature ladder actually used
    ess_trace: torch.Tensor


def _systematic_resample(u, log_w, n):
    """Indices of n systematic draws from softmax(log_w) given the one
    uniform u.  Left-side search, as jnp.searchsorted; an index past the
    end (the cumulative sum rounds below 1) is clamped to the last
    particle, as a JAX gather clamps it."""
    cum = torch.cumsum(torch.softmax(log_w, 0), 0)
    pos = (u + torch.arange(n, dtype=log_w.dtype, device=log_w.device)) / n
    return torch.searchsorted(cum, pos).clamp_max(n - 1)


def _finite(lp):
    return torch.where(torch.isfinite(lp), lp, -1e12)


@torch.no_grad()
def run_smc(logp_fn: Callable, prior_sample: Callable, draws: Draws,
            n_particles: int = 512, n_stages: int = 20, n_mcmc: int = 5,
            ess_threshold: float = 0.5, rw_scale: float = 0.3) -> SmcResult:
    """Anneal from the prior (beta=0) to the posterior (beta=1) over a fixed
    ladder with ESS-triggered systematic resampling and RW-Metropolis moves.

    ``prior_sample(draws, n)`` draws the initial population (through
    ``draws.normal`` / ``draws.uniform``); ``logp_fn`` is the full
    (unnormalized) log posterior, batched over particles.
    """
    particles = draws.smc_prior(prior_sample, n_particles)
    dt = particles.dtype
    lp = _finite(logp_fn(particles))
    log_w = torch.zeros(n_particles, dtype=dt, device=particles.device)
    betas = torch.linspace(0.0, 1.0, n_stages + 1, dtype=torch.float64)
    ess_trace = []
    for i in range(n_stages):
        b0, b1 = float(betas[i]), float(betas[i + 1])
        log_w = log_w + (b1 - b0) * lp
        ess = torch.exp(2 * torch.logsumexp(log_w, 0)
                        - torch.logsumexp(2 * log_w, 0)) / n_particles
        ess_trace.append(ess)

        # resample where the ESS fell below the threshold; selected on the
        # device, so the stage reads nothing back
        u = draws.smc_resample_uniform(dt)
        idx = _systematic_resample(u, log_w, n_particles)
        rs = ess < ess_threshold
        particles = torch.where(rs, particles[idx], particles)
        lp = torch.where(rs, lp[idx], lp)
        log_w = torch.where(rs, torch.zeros_like(log_w), log_w)

        # RW-Metropolis mutation at temperature beta_{i+1}
        for _ in range(n_mcmc):
            prop = particles + rw_scale * draws.smc_proposal(particles.shape,
                                                            dt)
            lp_prop = _finite(logp_fn(prop))
            log_acc = b1 * (lp_prop - lp)
            accept = torch.log(draws.smc_accept_uniform(n_particles, dt)) \
                < log_acc
            particles = torch.where(accept[:, None], prop, particles)
            lp = torch.where(accept, lp_prop, lp)
    return SmcResult(particles=particles, log_weights=log_w,
                     betas=betas.to(dt), ess_trace=torch.stack(ess_trace))
