"""Row-parallel covariance matvec for large-n GPs over the ranks of a mesh
(counterpart of ``gpgradpy_tpu/parallel/sharded_matvec.py``).

The point set is split over the ranks: each assembles only ITS rows of the
gradient-enhanced covariance (its points against all points), one row tile
of ``row_block`` points at a time, never the whole row block, and multiplies
them against the vector; one ``all_gather`` gives every rank the whole
product.  So the vectors of a CG solve stay whole and the same on every
rank: ``ops/iterative.mbcg`` runs unchanged, and every scalar the host
reads (CG's convergence flags, L-BFGS's line search) is the same on every
rank, as it must be for the ranks to meet in the next collective.

On a CUDA device each row tile is K1 and its theta cotangent K2 (the
wrappers of ``ops/cuda_assembly.py``, which take their plain versions on
CPU tensors); the JAX package builds the whole local block tensor in plain
``jnp`` instead.

Layout: the sharded path works in the POINT-MAJOR layout, each point's value
and gradient rows contiguous, so a rank's rows are whole points.  K1 writes
a tile in the dense path's blocked layout ([values; gradients grouped by
dim]); the matvec permutes the vector once per call, not per tile.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops import cuda_assembly, iterative
from .mesh import Mesh, gather_batch, local_slice, make_mesh


def blocked_to_pointmajor(v: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """[vals(n); grads grouped by dim (n each)] -> (n, 1+dim)."""
    return torch.cat([v[:n, None], v[n:].reshape(dim, n).T], dim=1)


def pointmajor_to_blocked(V: torch.Tensor) -> torch.Tensor:
    """(n, 1+dim) -> [vals; grads grouped by dim]."""
    return torch.cat([V[:, 0], V[:, 1:].T.reshape(-1)])


def blocked_to_pm_mat(M: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """(n_data[, m]) in the blocked layout -> point-major flattened rows
    (n (1+dim)[, m]): each point's value and gradient rows contiguous."""
    M2 = M if M.ndim == 2 else M[:, None]
    out = M2.reshape(1 + dim, n, -1).transpose(0, 1).reshape(n * (1 + dim), -1)
    return out if M.ndim == 2 else out[:, 0]


def pm_to_blocked_mat(M: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Inverse of blocked_to_pm_mat."""
    M2 = M if M.ndim == 2 else M[:, None]
    out = M2.reshape(n, 1 + dim, -1).transpose(0, 1).reshape(n * (1 + dim), -1)
    return out if M.ndim == 2 else out[:, 0]


def make_data_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of the point axis: every rank of the process group
    (sharded_matvec.py:45-50 of the JAX package)."""
    return make_mesh(n_devices, device)


def shard_points(mesh: Mesh, *arrays):
    """This rank's points of each array (leading axis = points): the JAX
    package places the arrays sharded; here every rank holds them whole and
    takes its slice where it computes."""
    out = tuple(a[local_slice(mesh, a.shape[0])] for a in arrays)
    return out if len(out) > 1 else out[0]


def _pm_rows(Mb: torch.Tensor, A: int) -> torch.Tensor:
    """Rows blocked over a run of points ((A n_r, m)) -> point-major."""
    m = Mb.shape[1]
    return Mb.reshape(A, -1, m).transpose(0, 1).reshape(-1, m)


def _matvec(kernel_type, mesh, row_block, x, theta, alpha, V):
    """K V for the point-major V (n (1+d), m): this rank's rows (K1 per
    tile of its points, ``ops/iterative._matvec_k1``), gathered."""
    n, dim = x.shape
    Vb = pm_to_blocked_mat(V, n, dim)
    loc = iterative._matvec_k1(kernel_type, x, theta, alpha, Vb, row_block,
                               local_slice(mesh, n))
    return gather_batch(_pm_rows(loc, dim + 1), mesh)


class ShardedMatvecFn(torch.autograd.Function):
    """K(theta) V with the rows split over the ranks, V and the output whole
    on every rank (point-major): ``ops/iterative.KernMatvecFn`` on this
    rank's points, then one ``all_gather``.  Backward: the cotangent g of
    the output is the same on every rank, so each rank takes only its own
    rows of g (the backward of a gather whose every consumer is
    replicated; a reduce-scatter would count g world-size times): K2 per
    tile (``ops/iterative._theta_vjp_k2``), then an ``all_reduce`` sum of
    the (d,) partials; the V cotangent is one more sharded matvec (K is
    symmetric).  No x or alpha cotangent (no iterative path asks for
    one)."""

    @staticmethod
    def forward(ctx, kernel_type: str, mesh: Mesh, row_block: int, x, theta,
                alpha, V):
        ctx.kernel_type, ctx.mesh, ctx.row_block = kernel_type, mesh, row_block
        ctx.alpha = alpha              # None, a float or a tensor; no cotangent
        ctx.save_for_backward(x, theta, V)
        return _matvec(kernel_type, mesh, row_block, x, theta, alpha, V)

    @staticmethod
    def backward(ctx, g):
        x, theta, V = ctx.saved_tensors
        alpha = ctx.alpha
        kt, mesh, rb = ctx.kernel_type, ctx.mesh, ctx.row_block
        need_x, need_theta, need_alpha, need_V = ctx.needs_input_grad[3:7]
        if need_x or need_alpha:
            raise NotImplementedError(
                "the sharded matvec has no x or alpha cotangent")
        g_theta = g_V = None
        if need_theta:
            n, dim = x.shape
            A = dim + 1
            sl = local_slice(mesh, n)
            g_loc = g[sl.start * A:sl.stop * A].reshape(-1, A, g.shape[1])
            g_theta = iterative._theta_vjp_k2(
                kt, x, theta, alpha, pm_to_blocked_mat(V, n, dim),
                g_loc.transpose(0, 1), rb, sl)
            dist.all_reduce(g_theta, group=mesh.group)
        if need_V:
            g_V = _matvec(kt, mesh, rb, x, theta, alpha, g)
        return None, None, None, None, g_theta, None, g_V


def kern_matvec_sharded_batch(kernel_type: str, mesh: Mesh, x: torch.Tensor,
                              theta, alpha, V2: torch.Tensor,
                              eta: float = 0.0,
                              pvec2_pm: Optional[torch.Tensor] = None,
                              row_block: int = 256) -> torch.Tensor:
    """(K + eta diag(pvec2)) V2 in the point-major flattened layout:
    V2 (n (1+dim), m) with rows grouped by point (blocked_to_pm_mat), x
    (n, dim), both whole on every rank; mesh.size must divide n so that the
    ranks split at point boundaries.  ``pvec2_pm``: the flattened P^2
    diagonal (ones if None); it may carry a gradient (the noisy likelihood's
    noise terms).  Returns (n (1+dim), m) on every rank: the building block
    of the distributed CG/SLQ marginal likelihood."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"mesh.size ({mesh.size}) must divide n ({n}) so "
                         f"shards split at point boundaries")
    needs_graph = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, theta, alpha, V2))
    if needs_graph:
        out = ShardedMatvecFn.apply(kernel_type, mesh, row_block, x, theta,
                                    alpha, V2)
    else:
        out = _matvec(kernel_type, mesh, row_block, x, theta, alpha, V2)
    if eta:
        p2 = torch.ones_like(V2[:, 0]) if pvec2_pm is None else pvec2_pm
        out = torch.addcmul(out, (eta * p2)[:, None], V2)
    return out


def kern_matvec_sharded(kernel_type: str, mesh: Mesh, x: torch.Tensor,
                        theta, alpha, V: torch.Tensor, eta: float = 0.0,
                        pvec2_pm: Optional[torch.Tensor] = None,
                        row_block: int = 256) -> torch.Tensor:
    """(K + eta diag(pvec2)) V for one vector V (n, 1+dim) point-major,
    ``pvec2_pm`` (n, 1+dim) likewise; returns (n, 1+dim)."""
    n, A = V.shape
    out = kern_matvec_sharded_batch(
        kernel_type, mesh, x, theta, alpha, V.reshape(-1, 1), eta,
        None if pvec2_pm is None else pvec2_pm.reshape(-1), row_block)
    return out.reshape(n, A)


def cross_cov_sharded(kernel_type: str, mesh: Mesh, x: torch.Tensor,
                      xq: torch.Tensor, theta, alpha) -> torch.Tensor:
    """cov(training value/derivative rows, f(xq)) in point-major rows
    (n (1+dim), nx): each rank's points against the queries (K1's value
    columns), gathered."""
    nx = xq.shape[0]
    sl = local_slice(mesh, x.shape[0])
    A = x.shape[1] + 1
    K = cuda_assembly.kern_grad(kernel_type, x[sl], xq, theta, alpha)
    return gather_batch(_pm_rows(K[:, :nx], A), mesh)
