"""The process group of the multi-device paths, the chain-sharded sampler
and multistart fit, and a spawner of one process group per world size
(counterpart of ``gpgradpy_tpu/parallel/mesh.py``).

The JAX package lays a batch axis over a ``jax.sharding.Mesh`` of devices
and reduces across it with ``psum``/``pmean`` inside ``shard_map``.  Here
the devices are the ranks of a ``torch.distributed`` process group, one
device per rank, and a ``Mesh`` value names the group, this rank, the
world size and the rank's device.  Every rank runs the same program on its
own slice of the batch; the collectives are explicit calls.  The JAX
package's ``sharded_chain_map`` (a ``shard_map`` over the chain axis) has
no counterpart beyond ``shard_batch`` and ``gather_batch`` around a batch
function, with cross-chain reductions through ``cross_chain_mean``.

Backends: NCCL for a CUDA device, gloo for the CPU.  A failed
initialization raises; the backend is never swapped for another.  Without
an initialized group, ``make_mesh`` builds a world-size-1 group on the
model's device (the JAX package's "all local devices" on one card);
``torchrun`` (or any launcher that sets ``RANK`` / ``WORLD_SIZE`` /
``MASTER_ADDR``) gives a group of several ranks.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

# where a group of one rank keeps its file store (no network)
STORE_DIR = Path(__file__).resolve().parents[2] / "build" / "gpgradpy_torch"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: the ranks of ``group``, one device each (``make_mesh``,
    mesh.py:24-30 of the JAX package).  ``size`` is the world size."""
    group: object
    rank: int
    size: int
    device: torch.device
    backend: str


def backend_for(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device) -> torch.device:
    """The device of this rank: a CUDA device without an index becomes
    ``cuda:LOCAL_RANK`` (``torchrun`` sets it; 0 otherwise)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def distributed_initialize(device="cuda", init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None):
    """``init_process_group`` for ``device``'s backend, unless a group
    exists already (then a no-op, as mesh.py:33-40 of the JAX package).

    Rank, world size and address come from the arguments, else from the
    launcher's environment (``env://``), else a group of one rank on a
    ``file://`` store under ``build/``."""
    if dist.is_initialized():
        return
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            init_method = "env://"
        else:
            STORE_DIR.mkdir(parents=True, exist_ok=True)
            store = STORE_DIR / f"store_{os.getpid()}_{time.time_ns()}"
            init_method = f"file://{store}"
            rank, world_size = 0, 1
    if init_method != "env://":
        rank = int(os.environ.get("RANK", 0)) if rank is None else rank
        world_size = (int(os.environ.get("WORLD_SIZE", 1))
                      if world_size is None else world_size)
    dist.init_process_group(backend_for(device), init_method=init_method,
                            rank=rank, world_size=world_size)


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of every rank of the default group on ``device``
    (initialized on first use).  ``n_devices`` must be None or the world
    size: a smaller mesh is a smaller group of processes, launched as
    such."""
    distributed_initialize(device)
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}: this process group has "
                         f"{size} ranks (launch that many processes)")
    device = rank_device(device)
    backend = dist.get_backend()
    if backend != backend_for(device):
        raise ValueError(f"the process group runs {backend}, the device "
                         f"{device} needs {backend_for(device)}")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                device=device, backend=backend)


def local_slice(mesh: Mesh, n: int) -> slice:
    """The rows of a leading axis of length ``n`` that this rank holds:
    contiguous blocks, rank 0 first."""
    if n % mesh.size:
        raise ValueError(f"the mesh size ({mesh.size}) must divide the "
                         f"leading axis ({n})")
    n_loc = n // mesh.size
    return slice(mesh.rank * n_loc, (mesh.rank + 1) * n_loc)


def shard_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of the leading axis of ``x`` (the same on every
    rank), on its device (mesh.py:72-75 of the JAX package)."""
    return x[local_slice(mesh, x.shape[0])].to(mesh.device)


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis, rank 0
    first, on every rank (one ``all_gather``).  bool goes as uint8."""
    is_bool = x.dtype == torch.bool
    t = (x.to(torch.uint8) if is_bool else x).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    out = torch.cat(parts, dim=0)
    return out.bool() if is_bool else out


def cross_chain_mean(mesh: Mesh) -> Callable:
    """The mean over ALL chains, given back to every chain: the local
    ``nuts.chain_mean``, then an ``all_reduce`` mean over the ranks (each
    holds as many chains).  For ``nuts.run_nuts(cross_chain_mean=...)``
    (mesh.py:57-69 of the JAX package)."""
    def reduce_fn(x):
        local = x.mean(0, keepdim=True)
        dist.all_reduce(local, group=mesh.group)
        return (local / mesh.size).expand_as(x)
    return reduce_fn


def run_nuts_sharded(logp_fn: Callable, z0: torch.Tensor, seed: int,
                     mesh: Mesh, n_warmup: int = 500, n_samples: int = 500,
                     max_depth: int = 8, cross_chain_adapt: bool = True,
                     **nuts_kw):
    """NUTS with the chain axis split over the ranks (mesh.py:78-117 of the
    JAX package).  ``z0`` (n_chains, n) holds every chain's start, the same
    on every rank; each rank runs its contiguous block of chains, drawing
    from the streams of their global indices (``Draws(seed,
    chain_offset)``), so a chain's draws do not depend on the world size.
    With ``cross_chain_adapt`` the step size and mass matrix adapt on the
    statistics pooled over all chains (``cross_chain_mean``): the same
    sampler as one process running ``run_nuts(...,
    cross_chain_mean=nuts.chain_mean)`` over every chain.  Returns the
    samples (n_chains, n_samples, n) and the diagnostics, gathered to every
    rank."""
    from ..inference import nuts
    from ..inference.draws import Draws
    n_chains = z0.shape[0]
    sl = local_slice(mesh, n_chains)
    draws = Draws(seed, mesh.device, chain_offset=sl.start)
    zs, diag = nuts.run_nuts(
        logp_fn, z0[sl].to(mesh.device), draws, n_warmup=n_warmup,
        n_samples=n_samples, max_depth=max_depth,
        cross_chain_mean=cross_chain_mean(mesh) if cross_chain_adapt
        else None, **nuts_kw)
    return (gather_batch(zs, mesh),
            {k: gather_batch(v, mesh) for k, v in diag.items()})


def lbfgs_sharded(fun: Callable, x0_all: np.ndarray, lb: np.ndarray,
                  ub: np.ndarray, mesh: Mesh, **lbfgs_kw):
    """``fit/lbfgs.lbfgs_box_multistart`` with the starts split over the
    ranks: each rank runs its block of starts (no collective inside), then
    every field of the result is gathered to every rank, in start order.
    The JAX package gets this by sharding the starts of its vmapped solver
    (tests/test_sharding.py)."""
    from ..fit import lbfgs
    sl = local_slice(mesh, x0_all.shape[0])
    res = lbfgs.lbfgs_box_multistart(fun, x0_all[sl], lb, ub, **lbfgs_kw)
    return type(res)(*(
        gather_batch(torch.as_tensor(np.ascontiguousarray(a),
                                     device=mesh.device), mesh).cpu().numpy()
        for a in res))


# ---------------------------------------------------------------------------
# one process group of spawned ranks
# ---------------------------------------------------------------------------

_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _spawned_rank(rank, world, store, device_type, threads, fn, args, queue):
    if device_type == "cpu":
        torch.set_num_threads(threads)
    device = (torch.device("cuda", rank) if device_type == "cuda"
              else torch.device("cpu"))
    try:
        distributed_initialize(device, init_method=f"file://{store}",
                               rank=rank, world_size=world)
        queue.put((rank, fn(make_mesh(device=device), *args), None))
    except Exception:  # handed to the parent, which raises it
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_spawned(fn: Callable, world: int, device="cpu", args=(),
                timeout: float = 1800.0) -> list:
    """``fn(mesh, *args)`` on ``world`` ranks, each a spawned process of
    one new process group (a ``file://`` store under ``build/``, no
    network): rank r on ``cuda:r`` (NCCL) or on the CPU (gloo, this
    process's torch threads split between the ranks).  Returns every
    rank's result, rank order.  ``fn`` and ``args`` must pickle (a
    module-level function).
    Raises a rank's exception, a rank's exit without a result, or a
    TimeoutError after ``timeout`` seconds (a deadlocked collective)."""
    import torch.multiprocessing as mp
    device_type = torch.device(device).type
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"world size {world}: {torch.cuda.device_count()} "
                         f"GPU(s) visible, one rank per GPU")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    STORE_DIR.mkdir(parents=True, exist_ok=True)
    store = STORE_DIR / f"store_w{world}_{os.getpid()}_{time.time_ns()}"
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_spawned_rank,
                         args=(r, world, store, device_type, threads, fn,
                               args, queue))
             for r in range(world)]
    # the ranks' BLAS pools get their share of the threads: idle BLAS threads
    # that spin for work stall the other ranks' collectives
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: str(threads) for k in _THREAD_VARS})
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    results, errors, reported = {}, [], set()
    deadline = time.monotonic() + timeout
    try:
        while len(reported) < world:
            try:
                rank, res, err = queue.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in reported]
                if dead and queue.empty():
                    raise RuntimeError(
                        f"world size {world}: ranks {dead} exited without a "
                        f"result") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world size {world}: no result after "
                                       f"{timeout} s") from None
                continue
            reported.add(rank)
            if err is None:
                results[rank] = res
            else:
                errors.append(f"rank {rank}: {err}")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]
