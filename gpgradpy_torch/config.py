"""Typed configuration of the gradient-enhanced GP, PyTorch port.

A copy of ``gpgradpy_tpu.config.GpConfig`` (the JAX package's option
surface) without ``use_pallas``: the covariance takes the hand-written CUDA
kernels whenever its tensors lie on a CUDA device, with no switch, in
float32 and float64 alike (the f64 polish re-fit too).  The multi-device
options (``solver="dense_dist"`` with ``dist_chol_block``,
``iter_use_mesh``) run over the ranks of a ``torch.distributed`` process
group (``parallel/``), where the JAX package runs over the devices of a
``jax.sharding.Mesh``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

KERNEL_TYPES = ("SqExp", "Ma5f2", "RatQu")

WELLCOND_MTD_AVAIL = (
    "base",              # only use a positive nugget
    "precon",            # diagonal preconditioner on the correlation matrix
    "rescale_origin",    # rescaling method, vmin depends on n_eval, const eta
    "rescale_eta_vary",  # rescaling with set vmin and variable eta
    "dflt_vmin",         # set min point distance to cond_dist_min_dflt
    "dflt_vmax",         # set max point distance to cond_dist_max_dflt
)


@dataclass(frozen=True)
class GpConfig:
    """Static configuration (frozen, hashable)."""

    # --- structural choices ---
    dim: int = 1
    use_grad: bool = True
    kernel_type: str = "SqExp"
    wellcond_mtd: str = "precon"
    mean_fun_type: str = "poly_ord_0"   # 'poly_ord_0' or 'poly_ord_1'

    # --- hyperparameter optimization ---
    optz_mtd: str = "lbfgs"               # 'lbfgs' (batched) or 'slsqp' /
                                          # 'trust-constr' (scipy driver)
    optz_n_x0: int = 5
    optz_iter_max: int = 250
    optz_tol_obj: float = 1e-12
    optz_tol_x: float = 1e-12

    optz_log_hp_theta: bool = True
    optz_log_hp_var: bool = True
    optz_log_hp_kernel: bool = True

    # --- marginal log-likelihood ---
    lkd_optz_start_mtd: str = "hp_best"   # 'hp_best' or 'lhs'
    lkd_hp_best_n_eval: int = 40

    lkd_varK_pnlt_use: bool = False
    lkd_varK_pnlt_lb_var: float = 0.1
    lkd_varK_pnlt_c1: float = 1.0
    lkd_varK_pnlt_c2: float = 10.0

    # --- hyperparameter init / ranges ---
    hp_const_n_eval: int = 1
    hp_lhs_bound_factor: float = 1e3
    hp_box_bound_factor: float = 1e5
    hp_median_n_idx: int = 5

    hp_theta_init: float = 1e-2
    hp_varK_init: float = 1.0
    hp_var_fval_init: float = 0.0
    hp_var_fgrad_init: float = 0.0

    hp_theta_range: Tuple[float, float] = (1e-18, 1e24)
    hp_varK_range: Tuple[float, float] = (1e-24, 1e14)
    hp_var_fval_range: Tuple[float, float] = (1e-8, 1e8)
    hp_var_fgrad_range: Tuple[float, float] = (1e-8, 1e8)

    # --- conditioning policy ---
    cond_eta_set_mtd: str = "Kbase_eta"   # 'Kbase_eta' | 'Kbase_eta_w_dim' | 'dflt_eta'
    cond_eta_is_const: bool = True
    cond_eta_dflt: float = 1e-8

    cond_max_target: float = 1e10
    cond_max: float = 1e10
    cond_max_abs: float = 1e16
    cond_norm: int = 2                    # 2 (spectral, eigh) or 'fro'

    # --- rescaling methods ---
    cond_dist_min_dflt: float = 1.0       # 'dflt_vmin': min point distance
    cond_dist_max_dflt: float = 1.0       # 'dflt_vmax': max point distance

    cond_vreq_max_iter: int = 3           # rescale fixed-point iterations
    vmin_rescale_eta_vary: float = 1.0    # 'rescale_eta_vary': min distance
    cond_vreq_iter_tol: float = 1e-1      # fixed-point stop on theta spread

    # --- misc ---
    b_optz_hp_kernel: bool = True
    varK_min: float = 1e-32
    dtype: str = "float64"                # 'float64' or 'float32'
    n_refine_predict: int = 0             # mixed-precision predict: assemble
                                          # in f64, factor in f32, refine
                                          # every predict solve this many times
    polish_cond_target: float = 0.0       # > 0: after the main (f32) fit, a
                                          # warm single-start f64 re-fit at
                                          # this condition target, and the
                                          # predict in f64 at it too
    polish_iter_max: int = 20             # L-BFGS iterations of the polish
    pad_n_eval_multiple: int = 0          # shape bucketing: pad n_eval up to a
                                          # multiple (padded points are masked)

    # --- large-n iterative solver (model/likelihood_iter.py) ---
    solver: str = "dense"                 # 'dense' (Cholesky), 'iterative'
                                          # (matrix-free CG + SLQ) or
                                          # 'dense_dist' (the fit's Cholesky
                                          # distributed over the ranks,
                                          # fit/dense_dist_driver.py)
    iter_n_probes: int = 16               # Hutchinson / SLQ probe vectors
    iter_max_cg: int = 1024               # CG iteration cap (~sqrt(cond)
                                          # with the diagonal preconditioner)
    iter_cg_tol: float = 1e-10            # CG relative-residual tolerance
    iter_row_block: int = 256             # covariance row-tile height (points)
    iter_n_x0: int = 2                    # multistarts of the iterative fit
    iter_use_mesh: bool = False           # shard the matvec's rows over the
                                          # ranks of the process group (the
                                          # world size must divide n_eval)
    dist_chol_block: int = 64             # block of the distributed Cholesky
                                          # of 'dense_dist'; set_data pads
                                          # n_data onto a multiple of
                                          # world size * block

    def __post_init__(self):
        assert self.kernel_type in KERNEL_TYPES, f"unknown kernel {self.kernel_type}"
        assert self.wellcond_mtd in WELLCOND_MTD_AVAIL, (
            f"Requested method not available, wellcond_mtd : {self.wellcond_mtd}"
        )
        # gradient-free models always use 'base' (as the JAX package does)
        if not self.use_grad and self.wellcond_mtd != "base":
            object.__setattr__(self, "wellcond_mtd", "base")
        assert self.solver in ("dense", "iterative", "dense_dist"), \
            f"unknown solver {self.solver}"
        if self.solver == "iterative":
            assert not self.polish_cond_target, (
                "solver='iterative' does not combine with polish_cond_target "
                "(a dense-factorization feature)")
        assert self.dtype in ("float64", "float32"), f"unknown dtype {self.dtype}"
        if self.wellcond_mtd == "rescale_eta_vary":
            object.__setattr__(self, "cond_eta_is_const", False)

    # -- derived flags (same as the JAX package) --
    @property
    def b_use_cond_cstr(self) -> bool:
        return self.wellcond_mtd != "precon"

    @property
    def b_use_data_scl(self) -> bool:
        return ("rescale" in self.wellcond_mtd) or ("dflt_v" in self.wellcond_mtd)

    @property
    def kernel_has_hp(self) -> bool:
        return self.kernel_type == "RatQu"

    @property
    def hp_kernel_default(self) -> Optional[float]:
        return 2.0 if self.kernel_type == "RatQu" else None

    @property
    def hp_kernel_range(self) -> Tuple[float, float]:
        return (1e-3, 10.0) if self.kernel_type == "RatQu" else (float("nan"), float("nan"))

    @property
    def n_beta_coeff(self) -> int:
        if self.mean_fun_type == "poly_ord_0":
            return 1
        if self.mean_fun_type == "poly_ord_1":
            return 1 + self.dim
        raise ValueError(f"mean_fun_type = {self.mean_fun_type} not available")

    def replace(self, **kw) -> "GpConfig":
        return dataclasses.replace(self, **kw)
