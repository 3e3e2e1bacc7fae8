"""The random draws of the samplers, behind one small interface.

The JAX package draws from ``jax.random`` keys split per chain, per
doubling and per leaf, which torch cannot reproduce.  The port's samplers
take every draw from a ``Draws`` object instead, through one method per
draw site:

- NUTS (nuts.py): ``momentum`` (the momentum normal of a transition),
  ``direction`` (the direction bit of a doubling), ``leaf_uniform`` (the
  multinomial proposal of a leaf) and ``doubling_uniform`` (the proposal
  across a doubling);
- ADVI (vi.py): ``advi_eps`` (the reparameterization noise of a step);
- SMC (smc.py): ``smc_prior`` (the initial population), then per stage
  ``smc_resample_uniform`` and, per MCMC move, ``smc_proposal`` and
  ``smc_accept_uniform``.

By default every site draws from one CPU ``torch.Generator`` and moves the
draws to the model's device, so a card run and a CPU run with the same seed
see the same numbers.  Each call draws for every chain (particle, sample),
also for those that no longer need it, so that the stream does not depend
on which chains are still active.  A subclass may override the sites: the
parity tests replay the JAX package's key-split sequence through them.
"""

from __future__ import annotations

import numpy as np
import torch


class Draws:
    """A stream of random draws from a CPU ``torch.Generator`` seeded with
    ``seed``, delivered on ``device``."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.generator = torch.Generator().manual_seed(int(seed))
        self.device = torch.device(device)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type == "cuda":
            # pinned, so the copy does not wait for the stream's queued work
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # the two distributions every site draws from

    def normal(self, shape, dtype=torch.float64) -> torch.Tensor:
        return self._to_device(torch.randn(shape, generator=self.generator,
                                           dtype=dtype))

    def uniform(self, shape, dtype=torch.float64) -> torch.Tensor:
        """Uniform on [0, 1)."""
        return self._to_device(torch.rand(shape, generator=self.generator,
                                          dtype=dtype))

    # NUTS

    def momentum(self, n_chains: int, n: int, dtype) -> torch.Tensor:
        """(n_chains, n) standard normals: a transition's momentum."""
        return self.normal((n_chains, n), dtype)

    def direction(self, n_chains: int) -> torch.Tensor:
        """(n_chains,) bool: a doubling goes right where True."""
        return self.uniform((n_chains,)) < 0.5

    def leaf_uniform(self, n_chains: int, dtype) -> torch.Tensor:
        return self.uniform((n_chains,), dtype)

    def doubling_uniform(self, n_chains: int, dtype) -> torch.Tensor:
        return self.uniform((n_chains,), dtype)

    # ADVI

    def advi_eps(self, n_mc: int, n: int, dtype) -> torch.Tensor:
        return self.normal((n_mc, n), dtype)

    # SMC

    def smc_prior(self, prior_sample, n_particles: int) -> torch.Tensor:
        """The initial population: ``prior_sample(draws, n)`` draws it
        through ``normal`` / ``uniform`` of the draws it is given."""
        return prior_sample(self, n_particles)

    def smc_resample_uniform(self, dtype) -> torch.Tensor:
        """() uniform of the systematic resampling, drawn every stage."""
        return self.uniform((), dtype)

    def smc_proposal(self, shape, dtype) -> torch.Tensor:
        return self.normal(shape, dtype)

    def smc_accept_uniform(self, n_particles: int, dtype) -> torch.Tensor:
        return self.uniform((n_particles,), dtype)

    # checkpoints

    def get_state(self) -> np.ndarray:
        """The generator's state as a uint8 array (an npz entry)."""
        return self.generator.get_state().numpy()

    def set_state(self, state: np.ndarray):
        self.generator.set_state(torch.as_tensor(np.asarray(state, np.uint8)))
