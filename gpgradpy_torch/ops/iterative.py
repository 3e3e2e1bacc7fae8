"""Matrix-free iterative linear algebra for large-n gradient-enhanced GPs
(counterpart of ``gpgradpy_tpu/ops/iterative.py``).

The covariance is never materialized: a matvec assembles one row tile of
``row_block`` points against all points at a time (O(n_data * row_block)
memory), solves are batched preconditioned conjugate gradients (mBCG), and
log-determinants come from stochastic Lanczos quadrature (SLQ) on the CG
tridiagonals (the BBMM approach of Gardner et al. 2018).

On a CUDA device the matvec is ``KernMatvecFn``: K1 assembles each row tile
(the rectangular case of the covariance kernel, ragged last tile included)
and ``torch.matmul`` applies it; its theta gradient contracts each tile's
cotangent with K2.  CPU tensors take ``kern_matvec_plain``, the JAX
package's tile + einsum, differentiated by autograd.  The JAX package has no
Pallas kernel on this path (its matvec is XLA code); the CUDA route reuses
the two kernels of ``ops/cuda_assembly.py``.  A large matvec is bound by
device memory: K1 writes each tile and the product reads it back (PERF.md
has the times); a small one, as at n_eval=200, by the host's launches.

The CG loop is a host loop (the JAX package's ``lax.while_loop``): it reads
the convergence flags back to the host once every ``check_every``
iterations, and the iterations it runs past the last column's convergence
are exact no-ops (every column is frozen), so X, the Lanczos coefficients
and the iteration count come out as the JAX loop computes them.  On the
card the update after each matvec is one replay of a captured CUDA graph.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from . import cuda_assembly, graphs, kernels, rtensor


# iterations between two reads of the convergence flags on the host: each
# read waits for the device, so the loop runs up to this many - 1 frozen
# iterations past the last column's convergence
CHECK_EVERY = 8
# the probes' CG tolerance: the JAX package's slq_logdet runs mbcg at its
# default, whatever the solves' iter_cg_tol
SLQ_CG_TOL = 1e-10


def _tiles(n: int, row_block: int, rows: slice = slice(None)):
    """(start, stop) of each tile of ``row_block`` points in ``rows``."""
    start, stop, _ = rows.indices(n)
    return [(s, min(s + row_block, stop))
            for s in range(start, stop, row_block)]


def rademacher(n: int, m: int, seed: int, dtype=torch.float64,
               device="cpu") -> torch.Tensor:
    """(n, m) Rademacher probes from a CPU ``torch.Generator`` seeded with
    ``seed``, moved to ``device`` afterwards, so a card run and a CPU run
    see the same probes."""
    gen = torch.Generator().manual_seed(int(seed))
    z = torch.randint(0, 2, (n, m), generator=gen).to(dtype) * 2.0 - 1.0
    return z.to(device)


# ---------------------------------------------------------------------------
# Matrix-free gradient-enhanced covariance matvec
# ---------------------------------------------------------------------------

def kern_matvec_plain(kernel_type: str, x: torch.Tensor, theta, alpha,
                      V: torch.Tensor, row_block: int = 256) -> torch.Tensor:
    """K V for V (n (1+d), m) in the blocked layout, plain PyTorch: the
    block tensor of each point tile against all points, then the einsum
    (iterative.py:49-62 of the JAX package)."""
    n, dim = x.shape
    A = dim + 1
    vb = V.reshape(A, n, -1)
    outs = []
    for s, e in _tiles(n, row_block):
        G = kernels.kern_block_tensor(kernel_type,
                                      rtensor.calc_rtensor(x[s:e], x),
                                      theta, alpha)         # (A, A, b, n)
        outs.append(torch.einsum("abBn,bnm->aBm", G, vb))
    return torch.cat(outs, dim=1).reshape(A * n, -1)


def _matvec_k1(kernel_type, x, theta, alpha, V, row_block,
               rows: slice = slice(None)):
    """The rows of K V of the points ``rows`` (all by default), blocked
    over those points ((1+d) n_rows, m), with K1 per row tile: tile rows
    a*b + i of K1's blocked output land on rows a*n_rows + s + i."""
    tiles = _tiles(x.shape[0], row_block, rows)
    if len(tiles) == 1:   # one tile: K1's blocked rows are the layout's own
        s, e = tiles[0]
        return cuda_assembly.kern_grad(kernel_type, x[s:e], x, theta,
                                       alpha) @ V
    A = x.shape[1] + 1
    s0 = tiles[0][0]
    out = torch.empty((A, tiles[-1][1] - s0, V.shape[1]), dtype=V.dtype,
                      device=V.device)
    for s, e in tiles:
        Kt = cuda_assembly.kern_grad(kernel_type, x[s:e], x, theta, alpha)
        out[:, s - s0:e - s0] = (Kt @ V).reshape(A, e - s, -1)
    return out.reshape(-1, V.shape[1])


def _theta_vjp_k2(kernel_type, x, theta, alpha, V, gb, row_block,
                  rows: slice = slice(None)):
    """The theta cotangent of the rows ``rows`` of K V, from their
    cotangent ``gb`` ((1+d), n_rows, m), blocked over those points): K2 per
    row tile against gbar = g_tile V^T."""
    tiles = _tiles(x.shape[0], row_block, rows)
    A, s0 = x.shape[1] + 1, tiles[0][0]
    g_theta = torch.zeros_like(theta)
    for s, e in tiles:
        gbar = gb[:, s - s0:e - s0].reshape(A * (e - s), -1) @ V.T
        g_theta = g_theta + cuda_assembly.kern_grad_vjp_theta(
            kernel_type, x[s:e], x, theta, alpha, gbar)
    return g_theta


class KernMatvecFn(torch.autograd.Function):
    """K(theta) V on the card, never holding more than one row tile of K
    (and, in the backward, one tile of its cotangent): forward = K1 per
    tile + ``torch.matmul``; theta-cotangent = K2 per tile against
    gbar = g_tile V^T; V-cotangent = K g (K is symmetric).  The x and alpha
    cotangents are not computed: no iterative path asks for them (the fit
    refuses a fitted RatQu alpha)."""

    @staticmethod
    def forward(ctx, kernel_type: str, row_block: int, x, theta, alpha, V):
        ctx.kernel_type, ctx.row_block = kernel_type, row_block
        ctx.save_for_backward(x, theta, alpha, V)
        return _matvec_k1(kernel_type, x, theta, alpha, V, row_block)

    @staticmethod
    def backward(ctx, g):
        x, theta, alpha, V = ctx.saved_tensors
        kt, rb = ctx.kernel_type, ctx.row_block
        need_x, need_theta, need_alpha, need_V = ctx.needs_input_grad[2:6]
        if need_x or need_alpha:
            raise NotImplementedError(
                "the matrix-free matvec has no x or alpha cotangent")
        g_theta = g_V = None
        if need_theta:
            gb = g.reshape(x.shape[1] + 1, x.shape[0], -1)
            g_theta = _theta_vjp_k2(kt, x, theta, alpha, V, gb, rb)
        if need_V:
            g_V = _matvec_k1(kt, x, theta, alpha, g, rb)
        return None, None, None, g_theta, None, g_V


def kern_matvec(kernel_type: str, x: torch.Tensor, theta, alpha,
                v: torch.Tensor, row_block: int = 256,
                noise_over_varK: Optional[torch.Tensor] = None):
    """(Keta v) without materializing Keta, for the full-gradient square
    case: Keta = K + diag(noise_over_varK), where the caller folds any
    nugget (eta P^2) into that diagonal.  ``v`` is (n_data,) or (n_data,
    m).  CUDA tensors take ``KernMatvecFn`` (K1/K2), CPU tensors the plain
    version."""
    v2 = v if v.ndim == 2 else v[:, None]
    if theta.is_cuda:
        needs_graph = torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, theta, alpha, v2))
        # a solve needs no autograd record: K1 per tile without the Function
        Kv = (KernMatvecFn.apply(kernel_type, row_block, x, theta, alpha, v2)
              if needs_graph else
              _matvec_k1(kernel_type, x, theta, alpha, v2, row_block))
    else:
        Kv = kern_matvec_plain(kernel_type, x, theta, alpha, v2, row_block)
    if noise_over_varK is not None:
        Kv = torch.addcmul(Kv, noise_over_varK[:, None], v2)
    return Kv if v.ndim == 2 else Kv[:, 0]


# ---------------------------------------------------------------------------
# Batched preconditioned CG with Lanczos coefficient capture (mBCG)
# ---------------------------------------------------------------------------

class MbcgResult(NamedTuple):
    X: torch.Tensor            # solutions (n, m)
    alphas: torch.Tensor       # (max_iters, m) CG step sizes, 0 past the end
    betas: torch.Tensor        # (max_iters, m) CG direction updates
    residnorm: torch.Tensor    # (m,) final relative residual norms
    n_iter: torch.Tensor       # () iterations until every column converged


class _CgState:
    """The CG recurrences' state, updated in place, so that one iteration's
    vector update runs eagerly or as a replay of a captured CUDA graph."""

    def __init__(self, B, Minv, tol):
        m = B.shape[1]
        self.Minv, self.tol = Minv, tol
        b_norm = torch.linalg.vector_norm(B, dim=0)
        self.b_norm = torch.where(b_norm == 0, torch.ones_like(b_norm),
                                  b_norm)
        self.one = torch.ones(m, dtype=B.dtype, device=B.device)
        self.zero = torch.zeros(m, dtype=B.dtype, device=B.device)
        self.X = torch.zeros_like(B)
        self.R = B.clone()
        self.P = Minv * self.R
        self.rz = torch.sum(self.R * self.P, dim=0)
        self.done = torch.zeros(m, dtype=torch.bool, device=B.device)

    def update(self, Ap, record):
        """Everything of one iteration after the matvec Ap = A P; a column
        already converged is frozen (alpha = beta = 0).  ``record(alpha,
        beta)`` stores the step's coefficients."""
        pAp = torch.sum(self.P * Ap, dim=0)
        alpha = torch.where(self.done, self.zero,
                            self.rz / torch.where(pAp == 0, self.one, pAp))
        self.X.addcmul_(alpha, self.P)
        self.R.addcmul_(alpha, Ap, value=-1.0)
        Z = self.Minv * self.R
        rz_new = torch.sum(self.R * Z, dim=0)
        beta = torch.where(self.done, self.zero,
                           rz_new / torch.where(self.rz == 0, self.one,
                                                self.rz))
        self.P.mul_(beta).add_(Z)                   # P = Z + beta P
        self.rz.copy_(rz_new)
        self.done.logical_or_(
            torch.linalg.vector_norm(self.R, dim=0) / self.b_norm < self.tol)
        record(alpha, beta)


def mbcg(matvec: Callable, B: torch.Tensor, max_iters: int = 100,
         tol=1e-10, M_inv_diag: Optional[torch.Tensor] = None,
         check_every: int = CHECK_EVERY,
         graph: Optional[bool] = None) -> MbcgResult:
    """Modified batched CG: solves A X = B for all columns at once and
    records the (alpha, beta) recurrences that define each column's
    Lanczos tridiagonal.  A converged column is frozen (alpha = beta = 0),
    as in the JAX package; the loop ends once every column has converged,
    which the host reads every ``check_every`` iterations.  ``tol`` is a
    relative residual, one for all columns or an (m,) tensor of each's.

    On a CUDA device (``graph`` None or True) the vector update after each
    matvec, some 25 small kernels, is one replay of a captured CUDA graph:
    the same kernels on the same buffers, so the same numbers, for one
    launch.  The matvec stays outside the graph, so K1/K2 are launched (and
    counted) by their wrappers.  ``graph=False`` runs the update eagerly."""
    n, m = B.shape
    dt, dev = B.dtype, B.device
    Minv = (torch.ones(n, dtype=dt, device=dev) if M_inv_diag is None
            else M_inv_diag)[:, None]
    s = _CgState(B, Minv, tol)
    alphas = torch.zeros((max_iters, m), dtype=dt, device=dev)
    betas = torch.zeros((max_iters, m), dtype=dt, device=dev)
    use_graph = B.is_cuda if graph is None else graph
    warm = 2 if use_graph and max_iters > 2 else max_iters
    finished = False
    # the first iterations run eagerly, on the capture stream where a graph
    # follows (ops/graphs.py: library handles exist before the capture)
    with (graphs.on_side(dev) if warm < max_iters
          else contextlib.nullcontext()):
        for k in range(warm):
            s.update(matvec(s.P), lambda a, b: (alphas[k].copy_(a),
                                                betas[k].copy_(b)))
            if (k + 1) % check_every == 0 and bool(s.done.all()):
                finished = True
                break
    if warm < max_iters and not finished:
        Ap = torch.empty_like(B)
        row = torch.full((1,), warm, dtype=torch.int64, device=dev)

        def record(a, b):
            alphas.index_copy_(0, row, a[None])
            betas.index_copy_(0, row, b[None])
            row.add_(1)
        with graphs.on_side(dev):
            g, _ = graphs.capture(lambda: s.update(Ap, record))
        for k in range(warm, max_iters):
            Ap.copy_(matvec(s.P))
            g.replay()
            if (k + 1) % check_every == 0 and bool(s.done.all()):
                break
    res = torch.linalg.vector_norm(s.R, dim=0) / s.b_norm
    return MbcgResult(X=s.X, alphas=alphas, betas=betas, residnorm=res,
                      n_iter=iters_run(alphas))


def iters_run(alphas: torch.Tensor) -> torch.Tensor:
    """The iteration count of an mbcg run from its step sizes (max_iters,
    m), or of the columns sliced out of them: an iteration that starts with
    a live column gives it alpha != 0, and the loop stops once none is
    live, so the count is the last such row + 1 (at least 1, as the JAX
    loop runs once even on a zero right-hand side)."""
    max_iters = alphas.shape[0]
    if not max_iters:
        return torch.zeros((), dtype=torch.int64, device=alphas.device)
    live = (alphas != 0).any(dim=1).to(torch.int64)
    steps = torch.arange(1, max_iters + 1, device=alphas.device)
    return torch.clamp((steps * live).max(), min=1)


def lanczos_tridiag_from_cg(alphas: torch.Tensor, betas: torch.Tensor):
    """Lanczos T matrices (m, iters, iters) from the CG recurrences
    (iters, m): T[0,0] = 1/alpha_0; T[i,i] = 1/alpha_i +
    beta_{i-1}/alpha_{i-1}; T[i,i-1] = T[i-1,i] = sqrt(beta_{i-1})/alpha_{i-1};
    entries past a column's active iterations are an identity block."""
    a, b = alphas.T, betas.T
    safe_a = torch.where(a == 0, torch.ones_like(a), a)
    diag = 1.0 / safe_a
    diag = diag + torch.cat([torch.zeros_like(a[:, :1]),
                             b[:, :-1] / safe_a[:, :-1]], dim=1)
    off = torch.sqrt(torch.clamp_min(b[:, :-1], 0.0)) / safe_a[:, :-1]
    active = a != 0
    diag = torch.where(active, diag, torch.ones_like(diag))
    off = torch.where(active[:, :-1] & active[:, 1:], off,
                      torch.zeros_like(off))
    return (torch.diag_embed(diag) + torch.diag_embed(off, 1)
            + torch.diag_embed(off, -1))


def slq_logdet(matvec: Callable, z: torch.Tensor, max_iters: int = 64,
               scale_diag: Optional[torch.Tensor] = None):
    """Stochastic Lanczos quadrature estimate of log det A for SPD A from
    the probes ``z`` (n, n_probes): E_z[z^T log(A) z] from the eigenpairs of
    the CG-Lanczos tridiagonals.  With ``scale_diag`` = diag(A) it runs on
    A_hat = D^-1/2 A D^-1/2 and adds sum log scale_diag."""
    n = z.shape[0]
    if scale_diag is not None:
        d_isqrt = (1.0 / torch.sqrt(scale_diag))[:, None]

        def mv_hat(V):
            return d_isqrt * matvec(d_isqrt * V)
    else:
        mv_hat = matvec

    res = mbcg(mv_hat, z, max_iters=max_iters, tol=SLQ_CG_TOL)
    logdet = slq_quadrature(res.alphas, res.betas, n)
    if scale_diag is not None:
        logdet = logdet + torch.sum(torch.log(scale_diag))
    return logdet, res


def slq_quadrature(alphas: torch.Tensor, betas: torch.Tensor, n: int):
    """The SLQ estimate of log det A_hat from the CG coefficients (iters,
    n_probes) of Rademacher probes of length n: the mean over probes of
    n sum_j w_j log(lambda_j), with lambda_j, w_j the eigenvalues and
    squared first eigenvector components of each probe's tridiagonal.

    T is built only up to the iterations CG ran, not up to its
    ``max_iters`` as in the JAX package: the block beyond is an identity,
    whose eigenvectors have a zero first component and add 0 to the
    estimate.  A non-finite T gives NaN (``torch.linalg.eigh`` would
    raise)."""
    k = max(int(iters_run(alphas)), 1)
    T = lanczos_tridiag_from_cg(alphas[:k], betas[:k])
    bad = ~torch.isfinite(T).all(dim=-1).all(dim=-1)
    T = torch.where(bad[:, None, None],
                    torch.eye(k, dtype=T.dtype, device=T.device), T)
    evals, evecs = torch.linalg.eigh(T)
    evals = torch.clamp_min(evals, 1e-30)
    w = evecs[:, 0, :] ** 2
    # z_i^T log(A_hat) z_i ~ ||z_i||^2 sum_j w_j log(lambda_j); ||z||^2 = n
    est = n * torch.sum(w * torch.log(evals), dim=1)
    est = torch.where(bad, torch.full_like(est, float("nan")), est)
    return torch.mean(est)
