"""Distributed right-looking blocked Cholesky over the ranks of a mesh
(counterpart of ``gpgradpy_tpu/parallel/chol_dist.py``).

The mid-n direct branch of the large-n solvers: the matrix is ROW-SHARDED
over the ranks (contiguous blocks of n / world_size rows, the point layout
of ``sharded_matvec``), and each block step k

- sums the diagonal block A_kk out of its owner with a masked
  ``all_reduce`` (the JAX package's masked ``psum``), so every rank factors
  the same b x b tile;
- right-solves this rank's panel rows below it against L_kk^T
  (``torch.linalg.solve_triangular``, no communication);
- gathers the whole panel with one ``all_gather`` and updates this rank's
  trailing rows with one ``torch.matmul``, restricted to the trailing
  columns (the JAX loop multiplies the full width and masks the result:
  the same numbers).

Two collectives per block step, O(n b) bytes each.  The log-determinant is
summed with an ``all_reduce``.  Every shape is fixed by (n, block, world
size); a factorization that fails (a diagonal tile that is not positive
definite) is never read back to the host inside the loop: the failed
tile's factor is NaN, which the NaN-checking caller (``ops/linalg.
cholesky_ok_dist``) turns into its ``ok`` flag.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, local_slice


def cholesky_dist(mesh: Mesh, A: torch.Tensor, block: int = 64):
    """Blocked Cholesky of the SPD ``A`` (n, n), the same on every rank.

    Returns ``(L_loc, logdet)``: this rank's rows of the lower-triangular
    factor (n / mesh.size, n) and ``logdet = log det A``, the same on every
    rank.  ``gather_batch(L_loc, mesh)`` gives the whole factor.  ``n``
    must be a multiple of ``mesh.size * block`` (pad with identity rows and
    columns, as DataSpec.pad_mask does for the covariance: each adds log 1
    = 0 to the logdet)."""
    n = A.shape[-1]
    if A.shape != (n, n):
        raise ValueError(f"cholesky_dist takes one (n, n) matrix, got "
                         f"{tuple(A.shape)}")
    if n % (mesh.size * block):
        raise ValueError(f"n={n} must be a multiple of mesh.size*block="
                         f"{mesh.size * block}")
    sl = local_slice(mesh, n)
    row0, n_loc = sl.start, sl.stop - sl.start
    A_loc = A[sl].clone()
    panel = torch.empty((n_loc, block), dtype=A.dtype, device=A.device)
    parts = [torch.empty_like(panel) for _ in range(mesh.size)]
    for c0 in range(0, n, block):
        c1 = c0 + block
        owner = row0 <= c0 < row0 + n_loc
        # -- the diagonal block, from its owner to every rank --------------
        diag = (A_loc[c0 - row0:c1 - row0, c0:c1].clone() if owner
                else torch.zeros((block, block), dtype=A.dtype,
                                 device=A.device))
        dist.all_reduce(diag, group=mesh.group)
        L_kk, info = torch.linalg.cholesky_ex(diag)
        L_kk = torch.where(info == 0, L_kk, torch.nan)
        if owner:
            A_loc[c0 - row0:c1 - row0, c0:c1] = L_kk
        # -- this rank's panel rows below the block: A_ik L_kk^-T ----------
        lb = min(max(c1 - row0, 0), n_loc)
        Pl = torch.linalg.solve_triangular(L_kk.T, A_loc[lb:, c0:c1],
                                           upper=True, left=False)
        A_loc[lb:, c0:c1] = Pl
        if c1 == n:
            break
        # -- the whole panel (zero above the block) to every rank, then the
        # trailing update of this rank's rows ------------------------------
        panel.zero_()
        panel[lb:] = Pl
        dist.all_gather(parts, panel, group=mesh.group)
        if lb < n_loc:
            P_tail = torch.cat(parts, dim=0)[c1:]          # (n - c1, block)
            A_loc[lb:, c1:] -= Pl @ P_tail.T
    # lower triangle only: above the diagonal stand A's entries, untouched
    grows = torch.arange(row0, row0 + n_loc, device=A.device)
    cols = torch.arange(n, device=A.device)
    L_loc = torch.where(cols[None, :] <= grows[:, None], A_loc,
                        torch.zeros((), dtype=A.dtype, device=A.device))
    logdet = 2.0 * torch.log(A_loc[torch.arange(n_loc), grows]).sum()
    dist.all_reduce(logdet, group=mesh.group)
    return L_loc, logdet
