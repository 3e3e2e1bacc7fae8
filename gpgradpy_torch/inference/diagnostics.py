"""MCMC convergence diagnostics: split R-hat and effective sample size
(counterpart of ``gpgradpy_tpu/inference/diagnostics.py``), as tensor
reductions over the chain and sample axes."""

from __future__ import annotations

import torch


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-chain potential scale reduction factor (BDA3).

    samples: (n_chains, n_samples, dim) -> (dim,) R-hat per dimension.
    """
    c, s, d = samples.shape
    half = s // 2
    x = torch.cat([samples[:, :half], samples[:, half:2 * half]],
                  dim=0)                              # (2c, half, d)
    chain_mean = x.mean(1)                            # (2c, d)
    chain_var = x.var(1, correction=1)                # (2c, d)
    W = chain_var.mean(0)
    B = half * chain_mean.var(0, correction=1)
    var_plus = (half - 1) / half * W + B / half
    return torch.sqrt(var_plus / W)


def effective_sample_size(samples: torch.Tensor, max_lag: int = 100
                          ) -> torch.Tensor:
    """Cross-chain ESS via autocorrelation (Geyer initial positive sequence,
    truncated at the first negative paired sum or ``max_lag``).

    samples: (n_chains, n_samples, dim) -> (dim,) ESS per dimension.
    """
    c, s, d = samples.shape
    xc = samples - samples.mean((0, 1))
    max_lag = min(max_lag, s - 1)
    var0 = (xc ** 2).mean((0, 1))
    rhos = torch.stack([(xc[:, : s - lag] * xc[:, lag:]).mean((0, 1)) / var0
                        for lag in range(1, max_lag + 1)])   # (L, d)
    # Geyer: sum paired autocorrelations until a pair goes negative
    n_pairs = max_lag // 2
    pair = rhos[0:2 * n_pairs:2] + rhos[1:2 * n_pairs:2]    # (n_pairs, d)
    keep = torch.cumprod((pair > 0).to(rhos.dtype), 0)
    tau = torch.clamp_min(1.0 + 2.0 * (pair * keep).sum(0), 1e-6)
    return c * s / tau
