"""Per-iteration hyperparameter/telemetry history with npz checkpointing.

Copy of ``gpgradpy_tpu/fit/history.py`` (host-side numpy only), kept here so
that the port imports nothing of the JAX package.  Same array schema and
per-surrogate name prefixes, so the npz files of the two packages are
interchangeable.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_SCALAR_FIELDS = (
    "hp_varK", "hp_var_fval", "hp_var_fgrad", "hp_kernel",
    "min_nugget", "Kcov_cond", "eta_Kbase", "eta_Kgrad",
    "vmin_init", "vmin_req_grad",
    "hp_optz_success", "hp_optz_iter_mean", "hp_optz_iter_max",
    "hp_optz_con_good",
    "optz_n_cho_fail", "optz_n_cond2big", "optz_max_init_cond",
    "time_pick_hp0", "time_hp_optz", "time_chofac",
    "var_fval", "varK_var_fval", "ln_lkd",
)


class FitHistory:
    """Preallocated history arrays (GpParaDef.init_optz_surr, :20-65)."""

    def __init__(self, n_optz_max: int, dim: int, n_beta: int):
        self.n_optz_max = n_optz_max
        self.dim = dim
        self.n_beta = n_beta
        self.hp_beta = np.full((n_optz_max, n_beta), np.nan)
        self.hp_theta = np.full((n_optz_max, dim), np.nan)
        self.xvec_rescaling = np.full((n_optz_max, dim), np.nan)
        self.Kcov_cond_at_max = np.full(n_optz_max, False, dtype=bool)
        for f in _SCALAR_FIELDS:
            setattr(self, f, np.full(n_optz_max, np.nan))

    def store(self, i_optz: int, hp_vals, optz_info: Optional[dict] = None,
              cond_val: float = np.nan, cond_max: float = np.nan,
              eta_kbase: float = np.nan, eta_kgrad: float = np.nan,
              use_grad: bool = True, vmin_init: float = np.nan,
              vmin_req_grad: float = np.nan, xvec_scale=None,
              fval_in=None, ln_lkd: float = np.nan,
              time_hp_optz: float = np.nan, time_chofac: float = np.nan,
              time_pick_hp0: float = np.nan):
        """GpParaDef.store_new_para_surr (:219-283)."""
        i = i_optz

        def fl(v):
            return np.nan if v is None else float(np.asarray(v))

        if hp_vals.beta is not None:
            self.hp_beta[i, :] = np.asarray(hp_vals.beta)
        if hp_vals.theta is not None:
            self.hp_theta[i, :] = np.asarray(hp_vals.theta)
        self.hp_kernel[i] = fl(hp_vals.kernel)
        self.hp_varK[i] = fl(hp_vals.varK)
        self.hp_var_fval[i] = fl(hp_vals.var_fval)
        self.hp_var_fgrad[i] = fl(hp_vals.var_fgrad)

        self.min_nugget[i] = eta_kgrad if use_grad else eta_kbase
        self.Kcov_cond[i] = cond_val
        self.Kcov_cond_at_max[i] = bool(cond_val >= 0.99 * cond_max) \
            if np.isfinite(cond_val) else False
        self.eta_Kbase[i] = eta_kbase
        self.eta_Kgrad[i] = eta_kgrad
        self.vmin_init[i] = vmin_init
        self.vmin_req_grad[i] = vmin_req_grad
        if xvec_scale is not None:
            self.xvec_rescaling[i, :] = np.asarray(xvec_scale)

        if optz_info is not None:
            for k in ("hp_optz_success", "hp_optz_iter_mean",
                      "hp_optz_iter_max", "hp_optz_con_good",
                      "optz_n_cho_fail", "optz_n_cond2big",
                      "optz_max_init_cond"):
                if k in optz_info:
                    getattr(self, k)[i] = optz_info[k]

        self.time_hp_optz[i] = time_hp_optz
        self.time_chofac[i] = time_chofac
        self.time_pick_hp0[i] = time_pick_hp0
        self.ln_lkd[i] = ln_lkd

        if fval_in is not None:
            self.var_fval[i] = np.var(np.asarray(fval_in))
            if self.var_fval[i] > 0 and np.isfinite(self.hp_varK[i]):
                self.varK_var_fval[i] = self.hp_varK[i] / self.var_fval[i]

    def finish(self, n_final: int):
        """Truncate to the iterations actually run (GpParaDef.finish_optz_surr)."""
        for name in ("hp_beta", "hp_theta", "xvec_rescaling"):
            setattr(self, name, getattr(self, name)[:n_final])
        self.Kcov_cond_at_max = self.Kcov_cond_at_max[:n_final]
        for f in _SCALAR_FIELDS:
            setattr(self, f, getattr(self, f)[:n_final])
        self.n_optz_max = n_final

    # -- npz checkpoint with per-surrogate prefixes (GpParaDef.py:171-217) --

    def to_dict(self, surr_name: str = "obj_") -> dict:
        d = {surr_name + "hp_beta_all": self.hp_beta,
             surr_name + "hp_theta_all": self.hp_theta,
             surr_name + "xvec_rescaling_all": self.xvec_rescaling,
             surr_name + "Kcov_cond_at_max_all": self.Kcov_cond_at_max}
        for f in _SCALAR_FIELDS:
            d[surr_name + f + "_all"] = getattr(self, f)
        return d

    def export(self, path: str, surr_name: str = "obj_",
               keep_old: bool = True) -> dict:
        data = self.to_dict(surr_name)
        if path:
            if keep_old and os.path.isfile(path):
                os.replace(path, path.replace(".npz", "") + "_old.npz")
            np.savez(path, **data)
        return data

    def load(self, source, surr_name: str = "obj_"):
        """Load from a path or an npz dict into the preallocated arrays
        (GpParaDef.load_data_surr, :115-169)."""
        if isinstance(source, str):
            if not os.path.isfile(source):
                return
            source = np.load(source)
        idx = source[surr_name + "hp_beta_all"].shape[0]
        self.hp_beta[:idx] = source[surr_name + "hp_beta_all"]
        self.hp_theta[:idx] = source[surr_name + "hp_theta_all"]
        self.xvec_rescaling[:idx] = source[surr_name + "xvec_rescaling_all"]
        self.Kcov_cond_at_max[:idx] = source[surr_name + "Kcov_cond_at_max_all"]
        for f in _SCALAR_FIELDS:
            key = surr_name + f + "_all"
            if key in source:
                getattr(self, f)[:idx] = source[key]
