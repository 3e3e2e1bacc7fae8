"""Covariance assembly: kernel matrix + noise + conditioning + Cholesky
(counterpart of ``gpgradpy_tpu/model/assembly.py``).

With the 'precon' method the regularized covariance is
    Keta = K + diag(noise)/varK + eta * P^2,   P = diag(p),
    p = sqrt(diag(K + diag(noise)/varK)),
factorized via the well-conditioned correlation matrix
    M = P^-1 (K + diag(noise)/varK) P^-1 + eta I,   Keta = P M P,
so solves are ``P^-1 M^-1 P^-1 b`` and log det Keta = log det M + 2 sum log p.
With 'base', P = I and Keta = K + diag(noise)/varK + eta I.

Hyperparameters may carry a leading batch dimension (``theta`` (B, d)); every
tensor below then carries it too and each row is independent.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import GpConfig
from ..ops import cuda_assembly, kernels, linalg, rtensor
from ..types import DataSpec, GpData, Hypers


class KetaOps(NamedTuple):
    """Factorized regularized covariance (correlation scale, varK excluded)."""
    fac: linalg.CholFac     # Cholesky factor of the inner matrix M
    pvec: torch.Tensor      # (..., n) preconditioner diagonal (ones if not precon)
    logdet: torch.Tensor    # (...,) log det Keta (including the P transform)
    etaK: torch.Tensor      # (...,) nugget actually applied
    M: torch.Tensor         # (..., n, n) the factorized matrix
    ok: torch.Tensor        # (...,) Cholesky success flag

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Keta^-1 b for b of shape (..., n) or (..., n, k)."""
        vec = b.ndim == self.pvec.ndim
        rhs = b[..., None] if vec else b
        p = self.pvec[..., :, None]
        y = linalg.cho_solve(self.fac, rhs / p) / p
        return y[..., 0] if vec else y


class KernGradFn(torch.autograd.Function):
    """Gradient-enhanced covariance K(x, x) with the CUDA kernels on both
    passes (counterpart of ``_pallas_kern_ad``, assembly.py:74-108 of the JAX
    package): forward = K1, theta-cotangent = K2.  The x and alpha
    cotangents, which the MLL gradient does not ask for unless alpha is a
    fitted RatQu hyperparameter, come from autograd of the plain closed form
    and are computed only when ``ctx.needs_input_grad`` asks for them."""

    @staticmethod
    def forward(ctx, kernel_type: str, x, theta, alpha):
        ctx.kernel_type = kernel_type
        ctx.save_for_backward(x, theta, alpha)
        return cuda_assembly.kern_grad(kernel_type, x, x, theta, alpha)

    @staticmethod
    def backward(ctx, gK):
        x, theta, alpha = ctx.saved_tensors
        kt = ctx.kernel_type
        need_x, need_theta, need_alpha = ctx.needs_input_grad[1:4]
        g_x = g_theta = g_alpha = None
        if need_theta:
            g_theta = cuda_assembly.kern_grad_vjp_theta(kt, x, x, theta, alpha,
                                                        gK)
        if need_x or need_alpha:
            with torch.enable_grad():
                xd = x.detach().requires_grad_(need_x)
                ad = alpha.detach().requires_grad_(need_alpha) \
                    if alpha is not None else None
                K = kernels.kern_grad(kt, rtensor.calc_rtensor(xd, xd),
                                      theta.detach(), ad)
                wrt = [t for t, need in ((xd, need_x), (ad, need_alpha)) if need]
                grads = list(torch.autograd.grad(K, wrt, gK))
            g_x = grads.pop(0) if need_x else None
            g_alpha = grads.pop(0) if need_alpha else None
        return None, g_x, g_theta, g_alpha


def calc_noise_vec(spec: DataSpec, data: GpData, hp: Hypers) -> torch.Tensor:
    """Per-datum noise variance, (..., n_data_tot); padding entries get
    zero noise (they are masked anyway)."""
    x = data.x
    batch = hp.theta.shape[:-1]
    if spec.b_fval_zero and spec.b_fgrad_zero:
        return torch.zeros(spec.n_data_tot, dtype=x.dtype, device=x.device)

    def full(n, var):
        v = torch.as_tensor(0.0 if var is None else var, dtype=x.dtype,
                            device=x.device)
        return torch.ones(n, dtype=x.dtype, device=x.device) * v[..., None]

    if spec.known_eps_fval:
        nv_val = data.std_fval.to(x.dtype) ** 2
    else:
        nv_val = full(spec.n_eval_tot, hp.var_fval)
        if spec.n_pad_eval:
            pad_m = torch.as_tensor(spec.pad_mask()[:spec.n_eval_tot],
                                    dtype=x.dtype, device=x.device)
            nv_val = nv_val * pad_m
    if not spec.use_grad:
        return nv_val.expand(*batch, -1)

    if spec.known_eps_fgrad:
        nv_grad = (data.std_grad.to(x.dtype) ** 2).T.reshape(-1)
    else:
        nv_grad = full(spec.n_grad * spec.dim, hp.var_fgrad)
    return torch.cat([nv_val.expand(*batch, -1), nv_grad.expand(*batch, -1)],
                     dim=-1)


def compact_rows(n: int, dim: int, n_grad: int, device) -> torch.Tensor:
    """The rows of the compact gradient-enhanced layout (the values of all
    n points, then the gradients of the first ``n_grad`` points, grouped by
    dim) in the full blocked layout of all n points; built on ``device``
    from ranges, so no host data is copied."""
    grads = (n * torch.arange(1, dim + 1, device=device)[:, None]
             + torch.arange(n_grad, device=device))
    return torch.cat([torch.arange(n, device=device), grads.reshape(-1)])


def calc_kern(cfg: GpConfig, spec: DataSpec, x: torch.Tensor, hp: Hypers):
    """The (gradient-enhanced) kernel matrix of the training inputs.

    On a CUDA device the CUDA kernels K1/K2 build it (``KernGradFn``),
    whatever the size and dtype, when every real point carries gradients:
    the padding points of ``pad_n_eval_multiple`` and of
    ``solver="dense_dist"`` carry none, so their rows and columns are taken
    out of K1's full matrix (a few points more than the compact one), and
    K2's cotangent is the compact one scattered back.  CPU tensors and a
    partial gradient set (``idx_grad``, whose full matrix may be many times
    the compact one) take the plain closed form."""
    idx = spec.idx_grad_arr
    if x.is_cuda and cfg.use_grad and (idx is None
                                       or spec.n_grad == spec.n_eval):
        K = KernGradFn.apply(cfg.kernel_type, x, hp.theta, hp.kernel)
        if idx is None:
            return K
        rows = compact_rows(x.shape[0], x.shape[1], spec.n_eval, x.device)
        return K.index_select(-2, rows).index_select(-1, rows)
    R = rtensor.calc_rtensor(x, x)
    return kernels.kern_mat(cfg.kernel_type, R, hp.theta, hp.kernel,
                            use_grad=cfg.use_grad, idx_g1=idx, idx_g2=idx)


def _add_diag(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A + diag(v), out of place; v broadcasts against (..., n)."""
    out = A.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(v)
    return out


def _factor(M: torch.Tensor, factor_dtype, mesh=None,
            block: int = 64) -> linalg.CholFac:
    M = M if factor_dtype is None else M.to(factor_dtype)
    if mesh is not None:
        return linalg.cholesky_ok_dist(M, mesh, block)
    return linalg.cholesky_ok(M)


def assemble_keta(cfg: GpConfig, spec: DataSpec, data: GpData, hp: Hypers,
                  eta_const: float, varK: Optional[torch.Tensor] = None,
                  Kern: Optional[torch.Tensor] = None,
                  factor_dtype: Optional[torch.dtype] = None,
                  mesh=None) -> KetaOps:
    """Assemble and factorize the regularized covariance (correlation scale).

    ``varK`` scales the noise term only (K + diag(noise)/varK); in the
    noise-free regime pass varK=None (varK = 1).

    ``factor_dtype`` (torch.float32) factorizes a downcast copy of M and
    keeps M itself in the assembly precision: the refined predict's mode,
    whose solves refine against the full-precision M
    (``predict.choose_solve``).  The low-precision Cholesky's ok flag and
    identity fallback are those of the dense path.

    ``mesh`` (a ``parallel.mesh.Mesh``) factors M with the distributed
    blocked Cholesky (``linalg.cholesky_ok_dist``, block
    ``cfg.dist_chol_block``): ``solver="dense_dist"``.  One matrix, no
    batch; n_data must be a multiple of mesh.size * dist_chol_block."""
    if Kern is None:
        Kern = calc_kern(cfg, spec, data.x, hp)
    n_data = Kern.shape[-1]
    dt, dev = Kern.dtype, Kern.device

    # structural masking of padded points: identity rows/cols in the kernel
    pad_mask = spec.pad_mask()
    if pad_mask is not None:
        m = torch.as_tensor(pad_mask, dtype=dt, device=dev)
        Kern = _add_diag(Kern * (m[:, None] * m[None, :]), 1.0 - m)

    if spec.b_fval_zero and spec.b_fgrad_zero:
        Kw = Kern                       # the noise vector is all zeros
    else:
        noise = calc_noise_vec(spec, data, hp)
        varK_eff = 1.0 if varK is None else varK[..., None]
        Kw = _add_diag(Kern, noise / varK_eff)

    if cfg.wellcond_mtd == "precon":
        pvec = torch.sqrt(torch.diagonal(Kw, dim1=-2, dim2=-1))
        Kcor = Kw / (pvec[..., :, None] * pvec[..., None, :])
        if cfg.cond_eta_is_const:
            etaK = torch.full(Kcor.shape[:-2], eta_const, dtype=dt, device=dev)
        else:
            etaK = (torch.abs(Kcor).sum(-1).amax(-1)
                    / (cfg.cond_max_target - 1.0))
        M = _add_diag(Kcor, etaK[..., None])
        fac = _factor(M, factor_dtype, mesh, cfg.dist_chol_block)
        logdet = (linalg.logdet_from_chol(fac).to(dt)
                  + 2.0 * torch.log(pvec).sum(-1))
    else:
        pvec = torch.ones(Kw.shape[:-1], dtype=dt, device=dev)
        if cfg.cond_eta_is_const:
            etaK = torch.full(Kw.shape[:-2], eta_const, dtype=dt, device=dev)
        else:
            etaK = (torch.abs(Kern).sum(-1).amax(-1)
                    / (cfg.cond_max_target - 1.0))
        M = _add_diag(Kw, etaK[..., None])
        fac = _factor(M, factor_dtype, mesh, cfg.dist_chol_block)
        logdet = linalg.logdet_from_chol(fac).to(dt)

    if pad_mask is not None:
        # padded diagonal entries contribute log(1 + eta) each; remove them
        logdet = logdet - spec.n_pad_eval * torch.log1p(etaK)

    return KetaOps(fac=fac, pvec=pvec, logdet=logdet, etaK=etaK, M=M,
                   ok=fac.ok)


def calc_cond(ops: KetaOps, norm=2) -> torch.Tensor:
    """Condition number of the factorized matrix M: 2 -> spectral (eigh),
    'fro' -> Frobenius via Cholesky solves.  Both are differentiable: the
    constrained fit takes the gradient of either (assembly.py:210-223 of the
    JAX package)."""
    if norm == "fro":
        return linalg.cond_fro_w_chol(ops.M, ops.fac)
    assert norm == 2, f"cond_norm must be 2 or 'fro', got {norm!r}"
    return linalg.cond_eigh(ops.M)
