"""Mean-field variational inference (ADVI) over the same batched
log-posterior as NUTS (counterpart of ``gpgradpy_tpu/inference/vi.py``):
a diagonal Gaussian in the unconstrained space, reparameterized gradients,
Adam.  Each step evaluates the ``n_mc`` samples as one batch (on the card:
K1 forward, K2 in the backward)."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .draws import Draws


class ViResult(NamedTuple):
    mu: torch.Tensor          # variational mean (unconstrained space)
    log_sigma: torch.Tensor   # variational log std
    elbo_trace: torch.Tensor


def run_advi(logp_fn: Callable, z0: torch.Tensor, draws: Draws,
             n_steps: int = 1000, n_mc: int = 8,
             learning_rate: float = 5e-2) -> ViResult:
    """Maximize the ELBO  E_q[logp(z)] + H[q]  for q = N(mu, diag(sigma^2)),
    with ``logp_fn`` batched over the rows of z (n_mc, n)."""
    n = z0.shape[0]
    mu = z0.detach().clone().requires_grad_(True)
    log_sigma = torch.full_like(mu, -1.0).requires_grad_(True)
    # torch's Adam takes optax.adam's step: m_hat / (sqrt(v_hat) + eps) with
    # both moments bias-corrected and eps added after the square root
    opt = torch.optim.Adam([mu, log_sigma], lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    elbos = []
    for _ in range(n_steps):
        eps = draws.advi_eps(n_mc, n, z0.dtype)
        with torch.enable_grad():
            zs = mu + eps * torch.exp(log_sigma)
            logps = logp_fn(zs)
            logps = torch.where(torch.isfinite(logps), logps, -1e12)
            loss = -(logps.mean() + log_sigma.sum())    # entropy + const
            opt.zero_grad()
            loss.backward()
        opt.step()
        elbos.append(-loss.detach())
    return ViResult(mu=mu.detach(), log_sigma=log_sigma.detach(),
                    elbo_trace=torch.stack(elbos))


def sample_vi(result: ViResult, draws: Draws, n_samples: int):
    eps = draws.normal((n_samples, result.mu.shape[0]), result.mu.dtype)
    return result.mu + eps * torch.exp(result.log_sigma)
