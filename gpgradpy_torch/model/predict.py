"""Posterior prediction: mean, standard deviation and their first and
second derivatives at query points (counterpart of
``gpgradpy_tpu/model/predict.py``), for one hyperparameter row.

Precision: the predict runs in ``predict_dtype(cfg)``.  With
``cfg.dtype == 'float64'`` f32 inputs are promoted (the polish mode, whose
main fit ran in f32); with ``cfg.n_refine_predict`` the covariance is
assembled in f64 and factorized in f32.

``setup_eval`` chooses each state's solve of Keta once (``choose_solve``):
an f32 factor of an f64 M refines against M; a float64 factor on a CUDA
device solves through L^-1 (``InverseSolve``), as cuBLAS's triangular
solves with a few right-hand sides run one dependent block step after
another, where a product with L^-1 has no such chain and, at N ~ 2000,
reads an operand that stays in the L2 cache between queries; anything else
solves through the factor.

On a CUDA device with autograd off, ``eval_model`` and ``eval_model_var``
replay a CUDA graph of their own eager body (``PredictGraphs``): a query of
a few rows is ~80 small kernels behind ~270 torch calls on the host, and
the replay issues them in one call.  Elsewhere the eager body runs.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch

from ..config import GpConfig
from ..ops import graphs, kernels, linalg, rtensor
from ..types import DataSpec, GpData, Hypers, cast_float_tree
from . import assembly, likelihood, mean


class _Captured:
    """One captured predict: the query buffer it reads, its outputs packed
    into one flat buffer and their shapes (``_pack``), and the training
    data whose memory the graph reads."""

    def __init__(self, run, xq: torch.Tensor, data: GpData, pool):
        self.data, self.xq = data, xq.clone()
        with graphs.on_side(xq.device):
            run(self.xq)      # the warm-up; it also builds the state's L^-1
            self.graph, (self.flat, self.shapes) = graphs.capture(
                lambda: _pack(run(self.xq)), pool)


class PredictGraphs:
    """The CUDA graphs of one EvalState's predict and their counter.

    Key: the eager body (``_eval_model`` or ``_eval_model_var``), config,
    data spec, query rows and dtype, calc_grad, calc_hess.  The first query
    with a key warms up, captures and replays; later ones copy the query
    into the graph's buffer and replay.  The graphs read the state's
    factor or L^-1, its vectors and the training data in place (factored
    on one device whatever the solver, so no solve communicates), share one
    memory pool, as they replay in turn on one stream, and go with their
    state.

    ``counts``: captures, replays and eager calls (CPU tensors, autograd
    on), and the builds of the state's L^-1 (``graph_counts``)."""

    def __init__(self):
        self.entries = {}
        self.pool = None
        self.counts = {"captures": 0, "replays": 0, "eager": 0,
                       "inverse_builds": 0}

    def replay(self, fn, cfg, spec, data, state, xq, calc_grad, calc_hess):
        """fn's outputs at xq through its graph, copies the caller owns."""
        key = (fn, cfg, spec, xq.shape[0], xq.dtype, calc_grad, calc_hess)
        cap = self.entries.get(key)
        if cap is not None and cap.data is data:
            self.counts["replays"] += 1
        else:
            cap = _Captured(lambda x: fn(cfg, spec, data, state, x,
                                         calc_grad, calc_hess),
                            xq, data, self.pool)
            self.pool = cap.graph.pool()      # the first graph's, shared
            self.entries[key] = cap
            self.counts["captures"] += 1
        cap.xq.copy_(xq)
        cap.graph.replay()
        return _split(cap.flat.clone(), cap.shapes)


class InverseSolve:
    """Keta^-1 b for b (n, k) through the inverse of the factor: M^-1 =
    L^-T L^-1 as two matrix products (L^-T a transposed view), then one
    step of refinement against M.  The computed inverse carries errors of
    ~eps |L^-1| |L| |L^-1|, which a product with b near a column of M turns
    into errors up to cond(L) times those of a substitution (sig^2 near the
    data); the step brings them back to the residual's rounding.

    L^-1 (~N^3/3 operations, N x N) is built on the first call, never for
    a state without queries, and counted in ``counts["inverse_builds"]``."""

    def __init__(self, ops: assembly.KetaOps, counts: dict):
        self.ops, self.counts, self.linv = ops, counts, None

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        L, p = self.ops.fac.L, self.ops.pvec[:, None]
        if self.linv is None:
            eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
            self.linv = torch.linalg.solve_triangular(L, eye, upper=False)
            self.counts["inverse_builds"] += 1
        linv, rhs = self.linv, b / p
        y = linv.T @ (linv @ rhs)
        y = y + linv.T @ (linv @ (rhs - self.ops.M @ y))
        return y / p


def _refined_solve(ops: assembly.KetaOps, n_refine: int,
                   b: torch.Tensor) -> torch.Tensor:
    """Keta^-1 b for b (n, k) through the low-precision factor, refined
    ``n_refine`` times against the full-precision M."""
    p = ops.pvec[:, None]
    return linalg.refine_solve(ops.fac, ops.M, b / p, n_refine) / p


def choose_solve(cfg: GpConfig, ops: assembly.KetaOps,
                 counts: dict) -> Callable:
    """The state's solve of Keta (the module note): refined for a factor
    below M's precision, L^-1 for a float64 factor on a CUDA device."""
    L = ops.fac.L
    if cfg.n_refine_predict and L.dtype != ops.M.dtype:
        return functools.partial(_refined_solve, ops, cfg.n_refine_predict)
    if L.dtype == torch.float64 and L.device.type == "cuda":
        return InverseSolve(ops, counts)
    return ops.solve


class EvalState(NamedTuple):
    """Cached quantities for surrogate evaluation."""
    ops: assembly.KetaOps       # varK-normalized factorization
    invK_fdiff: torch.Tensor    # Keta^-1 (y - m)
    hp: Hypers                  # with beta and varK filled in
    cond: torch.Tensor
    pad_mask: Optional[torch.Tensor]  # spec.pad_mask() on the device
    idx_grad: Optional[torch.Tensor]  # spec.idx_grad_arr on the device
    graphs: PredictGraphs
    solve: Callable             # Keta^-1 b for b (n, k) (choose_solve)


def graph_counts(state: EvalState) -> dict:
    """Captures, replays, eager calls and inverse builds of the state's
    predict so far."""
    return dict(state.graphs.counts)


def predict_dtype(cfg: GpConfig) -> torch.dtype:
    """f64 when the config says so or when the refined predict is on."""
    if cfg.dtype == "float64" or cfg.n_refine_predict:
        return torch.float64
    return torch.float32


def setup_eval(cfg: GpConfig, spec: DataSpec, data: GpData, hp: Hypers,
               eta_const: float, calc_cond: bool = False) -> EvalState:
    """Factorize the varK-normalized covariance, choose its solve and cache
    Keta^-1 (y - m) through the factor (refined where the state's solve
    refines), in the predict precision (the module note)."""
    dt = predict_dtype(cfg)
    data, hp = cast_float_tree(data, dt), cast_float_tree(hp, dt)
    ops = assembly.assemble_keta(
        cfg, spec, data, hp, eta_const,
        varK=hp.varK if spec.b_has_noisy_data else None,
        factor_dtype=torch.float32 if cfg.n_refine_predict else None)
    data_vec = likelihood.make_data_vec(spec, data)
    pad_mask, idx = spec_tensors(spec, data.x)
    vand = mean.calc_aug_vand(cfg.mean_fun_type, data.x, spec.use_grad, idx)
    if pad_mask is not None:
        vand = vand * pad_mask[:, None]
        data_vec = data_vec * pad_mask
    graph_set = PredictGraphs()
    solve = choose_solve(cfg, ops, graph_set.counts)
    factor_solve = ops.solve if isinstance(solve, InverseSolve) else solve
    invK_fdiff = factor_solve((data_vec - vand @ hp.beta)[:, None])[:, 0]
    cond = (assembly.calc_cond(ops, cfg.cond_norm) if calc_cond
            else torch.tensor(float("nan")))
    return EvalState(ops=ops, invK_fdiff=invK_fdiff, hp=hp, cond=cond,
                     pad_mask=pad_mask, idx_grad=idx, graphs=graph_set,
                     solve=solve)


def spec_tensors(spec: DataSpec, x: torch.Tensor):
    """(pad mask, gradient index): ``spec.pad_mask()`` in x's dtype and
    ``spec.idx_grad_arr`` as longs, on x's device (None where the spec has
    none).  Built once per state: a host-to-device copy cannot be captured
    in a CUDA graph, and need not be repeated for every query."""
    pad_mask, idx = spec.pad_mask(), spec.idx_grad_arr
    if pad_mask is not None:
        pad_mask = torch.as_tensor(pad_mask, dtype=x.dtype, device=x.device)
    if idx is not None:
        idx = torch.as_tensor(idx, device=x.device)
    return pad_mask, idx


def cross_cov(cfg: GpConfig, spec: DataSpec, x_train, xq, hp: Hypers,
              pad_mask: Optional[torch.Tensor],
              idx: Optional[torch.Tensor]):
    """Kyx (n_data, nx) and dKxy_dx (nx*dim, n_data): cross covariance of the
    training data (values + used gradients) with the query points and with
    the query-point derivatives, with the pad mask and gradient index of
    ``spec_tensors``.  Plain PyTorch, as the JAX package leaves it to XLA
    (predict.py:81-93 there)."""
    R = rtensor.calc_rtensor(x_train, xq)
    G = kernels.kern_block_tensor(cfg.kernel_type, R, hp.theta, hp.kernel)
    dim = spec.dim

    def rows(col_block):
        blk = G[:, col_block]              # (1+d, n_train, nx)
        parts = [blk[0]]
        if spec.use_grad:
            parts += [blk[a] if idx is None else blk[a][idx]
                      for a in range(1, dim + 1)]
        return torch.cat(parts, dim=0)     # (n_data, nx)

    Kyx = rows(0)
    dKxy_dx = torch.cat([rows(b).T for b in range(1, dim + 1)], dim=0)

    if pad_mask is not None:
        Kyx = Kyx * pad_mask[:, None]
        dKxy_dx = dKxy_dx * pad_mask[None, :]
    return Kyx, dKxy_dx


def _hess_terms(cfg, spec, data, state, xq, Kxy_invK, dKxy_dx):
    """H (d, nx*d, n_data) and the d2(sig^2) term shared by eval_model and
    eval_model_var."""
    hp = state.hp
    nx, dim = xq.shape
    N = spec.n_data_tot
    Rq = rtensor.calc_rtensor(xq, data.x)
    H = kernels.kern_hess_x(cfg.kernel_type, Rq, hp.theta, hp.kernel,
                            use_grad=spec.use_grad, idx_g2=state.idx_grad)
    Ht = H.reshape(dim, dim, nx, N)
    term1 = torch.einsum("kiqm,qm->qki", Ht, Kxy_invK)
    solve_dK = state.solve(dKxy_dx.T)                      # (n_data, nx*d)
    D = dKxy_dx.reshape(dim, nx, N)
    S = solve_dK.T.reshape(dim, nx, N)
    term2h = torch.einsum("kqm,iqm->qki", D, S)
    return H, -2.0 * hp.varK * (term1 + term2h)


def _predict(fn, cfg, spec, data, state, xq, calc_grad, calc_hess):
    """fn's outputs at xq, tensors that the caller owns: through the state's
    graphs on a CUDA device with autograd off, else eagerly (the module
    note)."""
    if not xq.is_cuda or torch.is_grad_enabled():
        state.graphs.counts["eager"] += 1
        return fn(cfg, spec, data, state, xq, calc_grad, calc_hess)
    return tuple(state.graphs.replay(fn, cfg, spec, data, state, xq,
                                     calc_grad, calc_hess))


def _split(flat, shapes):
    """The consecutive pieces of flat (a tensor or numpy array) in the
    given shapes; None where a shape is None."""
    out, i = [], 0
    for shape in shapes:
        if shape is None:
            out.append(None)
            continue
        n = math.prod(shape)
        out.append(flat[i:i + n].reshape(shape))
        i += n
    return out


def _pack(out):
    """The tensors of out in one flat buffer, and their shapes (None where
    a tensor is None)."""
    return (torch.cat([v.reshape(-1) for v in out if v is not None]),
            [None if v is None else tuple(v.shape) for v in out])


def to_host(out) -> list:
    """The tensors of out as numpy arrays (None kept), through one copy to
    the host: they are gathered into one buffer on the device first."""
    flat, shapes = _pack(out)
    return _split(flat.cpu().numpy(), shapes)


def eval_model(cfg: GpConfig, spec: DataSpec, data: GpData, state: EvalState,
               xq: torch.Tensor, calc_grad: bool = False,
               calc_hess: bool = False):
    """Returns (mu, sig, dmudx, dsigdx, d2mudx2, d2sigdx2) at the query
    points xq (nx, dim); derivative outputs are None unless requested."""
    return _predict(_eval_model, cfg, spec, data, state, xq, calc_grad,
                    calc_hess)


def eval_model_var(cfg: GpConfig, spec: DataSpec, data: GpData,
                   state: EvalState, xq: torch.Tensor,
                   calc_grad: bool = False, calc_hess: bool = False):
    """Variance (not std) and its derivatives: (sig2, dsig2dx, d2sig2dx2),
    None where not requested."""
    return _predict(_eval_model_var, cfg, spec, data, state, xq, calc_grad,
                    calc_hess)


def _eval_model(cfg, spec, data, state, xq, calc_grad, calc_hess):
    """The eager body of ``eval_model``."""
    hp = state.hp
    nx, dim = xq.shape
    dt = predict_dtype(cfg)
    data, xq = cast_float_tree(data, dt), xq.to(dt)
    varK = hp.varK
    sigK = torch.sqrt(varK)

    Kyx, dKxy_dx = cross_cov(cfg, spec, data.x, xq, hp, state.pad_mask,
                             state.idx_grad)
    Kxy_invK = state.solve(Kyx).T                          # (nx, n_data)
    mval, mgrad, mhess = mean.eval_mean_fun(cfg.mean_fun_type, xq, hp.beta)

    mu = mval + Kyx.T @ state.invK_fdiff
    sig2_wo = torch.clamp_min(1.0 - torch.sum(Kyx.T * Kxy_invK, dim=1), 0.0)
    sig = torch.sqrt(sig2_wo) * sigK

    dmudx = dsigdx = d2mudx2 = d2sigdx2 = None
    if calc_grad:
        dmudx = (dKxy_dx @ state.invK_fdiff).reshape(dim, nx).T + mgrad
        term2 = torch.sum(dKxy_dx * Kxy_invK.repeat(dim, 1), dim=1)
        pos = sig > 0
        inv_sig = torch.where(pos, 1.0 / torch.where(pos, sig, torch.ones_like(sig)),
                              torch.zeros_like(sig))
        dsigdx = -(inv_sig[:, None]) * term2.reshape(dim, nx).T * varK

    if calc_hess:
        if dsigdx is None:
            raise ValueError("calc_hess requires calc_grad")
        H, d2sig2 = _hess_terms(cfg, spec, data, state, xq, Kxy_invK, dKxy_dx)
        Hv = H @ state.invK_fdiff                          # (d, nx*d)
        d2mudx2 = Hv.reshape(dim, dim, nx).permute(2, 0, 1) + mhess
        sig_mod = torch.where(sig == 0, torch.full_like(sig, float("nan")), sig)
        outer = dsigdx[:, :, None] * dsigdx[:, None, :]
        d2sigdx2 = (d2sig2 - 2.0 * outer) / (2.0 * sig_mod[:, None, None])

    return mu, sig, dmudx, dsigdx, d2mudx2, d2sigdx2


def _eval_model_var(cfg, spec, data, state, xq, calc_grad, calc_hess):
    """The eager body of ``eval_model_var``."""
    hp = state.hp
    nx, dim = xq.shape
    dt = predict_dtype(cfg)
    data, xq = cast_float_tree(data, dt), xq.to(dt)
    varK = hp.varK

    Kyx, dKxy_dx = cross_cov(cfg, spec, data.x, xq, hp, state.pad_mask,
                             state.idx_grad)
    Kxy_invK = state.solve(Kyx).T
    sig2 = varK * torch.clamp_min(1.0 - torch.sum(Kyx.T * Kxy_invK, dim=1), 0.0)

    dsig2dx = d2sig2dx2 = None
    if calc_grad:
        term2 = torch.sum(dKxy_dx * Kxy_invK.repeat(dim, 1), dim=1)
        dsig2dx = -2.0 * term2.reshape(dim, nx).T * varK
    if calc_hess:
        _, d2sig2dx2 = _hess_terms(cfg, spec, data, state, xq, Kxy_invK,
                                   dKxy_dx)
    return sig2, dsig2dx, d2sig2dx2
