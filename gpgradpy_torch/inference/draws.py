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

The default stream is counter-based: every number is a hash (splitmix64)
of (seed, stream, site, counter, element), made on the host in numpy and
copied to the model's device, so a card run and a CPU run with the same
seed see the same numbers.  The NUTS sites give each chain its own stream,
as the JAX package gives each chain its own key: the stream is the chain's
global index (``chain_offset``, the global index of the first chain this
object draws for, plus its index in the local batch) and the counter is
that chain's own count of draws at the site.  When the chains are split
over ranks (``parallel/mesh.run_nuts_sharded``), each rank's ``Draws``
starts at its first chain's global index, so no two ranks share a stream.  A
site is handed the host mask of the chains that consume its draw (the
chains still building their tree); it returns a draw for every chain, and
only the consuming chains' counters advance.  So a chain's draws depend on
its own trajectory alone, not on the other chains in the lockstep group or
on their number.  Every other draw (``normal``, ``uniform`` and the ADVI
and SMC sites) comes from one stream per site, whose counter advances by
one per call.

A subclass may override the sites: the parity tests replay the JAX
package's key-split sequence through them.
"""

from __future__ import annotations

import numpy as np
import torch

# the columns of the counter table
_SITES = ("momentum", "direction", "leaf", "doubling", "normal", "uniform")
_COL = {s: i for i, s in enumerate(_SITES)}

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)


def _mix(z):
    """The splitmix64 finalizer (a bijection of uint64)."""
    z = (z ^ (z >> np.uint64(30))) * _M1
    z = (z ^ (z >> np.uint64(27))) * _M2
    return z ^ (z >> np.uint64(31))


def _bits(seed: int, stream, site: str, count, n_elem: int) -> np.ndarray:
    """uint64 hashes of (seed, stream, site, count, element) for streams
    (S,) with their counts (S,): shape (S, n_elem).  numpy's uint64
    arithmetic wraps."""
    with np.errstate(over="ignore"):
        h = _mix(np.full(1, seed, np.uint64) + _GOLDEN)
        for field in (np.asarray(stream, np.uint64),
                      np.uint64(_COL[site]), np.asarray(count, np.uint64)):
            h = _mix(h + (field + np.uint64(1)) * _GOLDEN)
        j = np.arange(n_elem, dtype=np.uint64)
        return _mix(h[:, None] + (j[None, :] + np.uint64(1)) * _GOLDEN)


def _uniform(bits: np.ndarray) -> np.ndarray:
    """[0, 1) from the top 53 bits."""
    return (bits >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def _normal(bits: np.ndarray) -> np.ndarray:
    """Box-Muller over consecutive pairs of the last axis: (..., 2 m) bits
    -> (..., m) standard normals."""
    u1 = ((bits[..., 0::2] >> np.uint64(11)).astype(np.float64) + 1.0) \
        * 2.0 ** -53                                  # (0, 1]
    u2 = _uniform(bits[..., 1::2])
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


class Draws:
    """Counter-based streams of random draws from ``seed``, delivered on
    ``device``.  ``counts`` (chains, sites) holds the per-chain counters of
    the NUTS sites; row 0 also counts the calls of the other sites.  The
    local chain i draws from the stream ``chain_offset + i``."""

    def __init__(self, seed: int = 0, device="cpu", chain_offset: int = 0):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.chain_offset = int(chain_offset)
        self.counts = np.zeros((0, len(_SITES)), np.uint64)

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(a)).to(dtype)
        if self.device.type == "cuda":
            # pinned, so the copy does not wait for the stream's queued work
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _rows(self, n: int):
        if self.counts.shape[0] < n:
            grow = np.zeros((n - self.counts.shape[0], len(_SITES)), np.uint64)
            self.counts = np.concatenate([self.counts, grow])

    def _per_chain(self, site: str, consume: np.ndarray, n_elem: int):
        """Bits of every chain's next draw at ``site``; the counters of the
        chains in the bool mask ``consume`` advance."""
        consume = np.asarray(consume, bool)
        B = consume.size
        self._rows(B)
        col = _COL[site]
        bits = _bits(self.seed, self.chain_offset + np.arange(B), site,
                     self.counts[:B, col], n_elem)
        self.counts[:B, col] += consume.astype(np.uint64)
        return bits

    def _shared(self, site: str, n_elem: int):
        """Bits of the next call at a site with one stream."""
        self._rows(1)
        col = _COL[site]
        bits = _bits(self.seed, [0], site, self.counts[:1, col], n_elem)[0]
        self.counts[0, col] += np.uint64(1)
        return bits

    # the two distributions of the shared streams

    def normal(self, shape, dtype=torch.float64) -> torch.Tensor:
        n = int(np.prod(shape, dtype=np.int64))
        z = _normal(self._shared("normal", 2 * n)).reshape(shape)
        return self._to_device(z, dtype)

    def uniform(self, shape, dtype=torch.float64) -> torch.Tensor:
        """Uniform on [0, 1)."""
        n = int(np.prod(shape, dtype=np.int64))
        return self._uniform_to(_uniform(self._shared("uniform", n))
                                .reshape(shape), dtype)

    # NUTS: one stream per chain

    def momentum(self, n_chains: int, n: int, dtype) -> torch.Tensor:
        """(n_chains, n) standard normals: a transition's momentum; every
        chain consumes it."""
        bits = self._per_chain("momentum", np.ones(n_chains, bool), 2 * n)
        return self._to_device(_normal(bits), dtype)

    def direction(self, active: np.ndarray) -> torch.Tensor:
        """(chains,) bool: a doubling goes right where True; consumed by the
        chains in the host mask ``active``."""
        bits = self._per_chain("direction", active, 1)[:, 0]
        return self._to_device((bits >> np.uint64(63)) == 1, torch.bool)

    def leaf_uniform(self, live: np.ndarray, dtype) -> torch.Tensor:
        """(chains,) uniforms of a leaf, consumed by the chains in ``live``."""
        return self._chain_uniform("leaf", live, dtype)

    def doubling_uniform(self, active: np.ndarray, dtype) -> torch.Tensor:
        """(chains,) uniforms of a doubling, consumed by the chains in
        ``active``."""
        return self._chain_uniform("doubling", active, dtype)

    def _chain_uniform(self, site, consume, dtype):
        return self._uniform_to(
            _uniform(self._per_chain(site, consume, 1)[:, 0]), dtype)

    def _uniform_to(self, u: np.ndarray, dtype) -> torch.Tensor:
        if dtype == torch.float32:
            # a float64 uniform below 1 may round up to 1.0 in float32
            u = np.minimum(u, np.nextafter(np.float32(1), np.float32(0)))
        return self._to_device(u, dtype)

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
        """The counter table (chains, sites) as uint64 (an npz entry); the
        seed is ``self.seed``."""
        return self.counts.copy()

    def set_state(self, state: np.ndarray, seed=None):
        self.counts = np.array(state, np.uint64).reshape(-1, len(_SITES))
        if seed is not None:
            self.seed = int(seed)
