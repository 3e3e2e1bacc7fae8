"""Stateful ``GaussianProcess`` facade over the functional core
(counterpart of ``gpgradpy_tpu/api.py``, dense and iterative solvers).

Same constructor, option surface (constructor kwargs and mutable
attributes) and methods as the JAX package's facade.  'precon' fits with
the batched L-BFGS; every other conditioning method ('base', the
rescaling methods) fits with the scipy driver under the condition-number
constraint, the rescaling methods in their scaled frame and, for
'rescale_*', inside the rescale fixed-point loop.  With
``solver="iterative"`` every method fits and predicts through the
matrix-free CG + SLQ likelihood instead (no condition number, no
Hessians); with ``iter_use_mesh`` its matvec rows are split over the ranks
of a ``torch.distributed`` process group.  ``solver="dense_dist"`` fits
'precon' with the fit's Cholesky distributed over those ranks, and
``sample_posterior(use_mesh=True)`` splits the chains over them
(``parallel/``; a group of one rank on the model's device where none is
initialized).  That group is the process's default group and is never
destroyed here: a later mesh path on the other device type (cpu after
cuda, or the reverse) raises until the caller runs
``torch.distributed.destroy_process_group()``, and its ``file://`` store
stays under ``build/gpgradpy_torch/``.  The model lives on one torch
device per rank:
``device="cuda"`` (the default) or ``device="cpu"``.  Without a card the
facade raises unless the CPU is asked for; it never moves to the CPU by
itself.

Precision (as in the JAX package): with ``polish_cond_target`` the main
(f32) fit is followed by a warm single-start f64 re-fit at that condition
target, and the closed form and the predict run in f64 at it
(``cfg_predict``); with ``n_refine_predict`` the predict factorizes in f32
and refines every solve against the f64 covariance.  Query points are cast
to the predict's precision, never to a lower fit precision.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import convert
from .config import GpConfig
from .fit import dense_dist_driver, iterative_driver, multistart, scipy_driver
from .fit.history import FitHistory
from .inference import nuts
from .inference.draws import Draws
from .model import (conditioning, likelihood, likelihood_iter, mean,
                    predict, predict_iter, rescale)
from .ops import rtensor
from .parallel import mesh as pmesh
from .types import (DataSpec, GpData, HpInfo, Hypers, cast_float_tree,
                    hp_vec_to_hypers, hypers_to_hp_vec, make_data_spec)

_CFG_FIELDS = {f.name for f in dataclasses.fields(GpConfig)}


def _torch_dtype(cfg: GpConfig) -> torch.dtype:
    return torch.float64 if cfg.dtype == "float64" else torch.float32


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


_NO_HESS = "iterative predict: Hessians not supported (use solver='dense')"


class GaussianProcess:

    def __init__(self, dim: int, use_grad: bool,
                 kernel_type: str = "SqExp",
                 wellcond_mtd: str = "precon",
                 mean_fun_type: str = "poly_ord_0",
                 path_data_surr: str = "baye_data_surr",
                 surr_name: str = "obj_",
                 device="cuda",
                 **config_overrides):
        assert isinstance(dim, int), "dim must be an integer"
        assert isinstance(use_grad, bool), "use_grad must be of type bool"
        assert isinstance(kernel_type, str), "kernel_type must be of type str"
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "GaussianProcess: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")

        if wellcond_mtd is None:
            wellcond_mtd = "base"

        object.__setattr__(self, "_overrides", {})
        self._overrides.update(
            dim=dim, use_grad=use_grad, kernel_type=kernel_type,
            wellcond_mtd=wellcond_mtd, mean_fun_type=mean_fun_type,
            **config_overrides)
        self._cfg_cache = None
        self.device = device
        self.cfg  # validate the options now

        self.path_data_surr = path_data_surr
        self.surr_name = surr_name
        self.path_surr_npz = path_data_surr + ".npz"

        self.spec: Optional[DataSpec] = None
        self.data: Optional[GpData] = None
        self.hp_vals: Optional[Hypers] = None
        self.hp_info_optz_lkd: Optional[HpInfo] = None
        self.history: Optional[FitHistory] = None
        self.DataScl: Optional[rescale.Rescaling] = None
        # optimizer telemetry of each inner fit of the last training round
        # (one, or one per iteration of the rescale fixed-point loop)
        self.optz_infos: list = []
        self._eval_state = None
        self._hp_vals_model_setup = None
        self._eta_Kbase = self._eta_Kgrad = self._etaK = np.nan
        self._vmin_init = np.nan
        self._vmin_req_grad = np.nan
        self._time_chofac = 0.0
        self._time_chofac_last = np.nan
        self._fit_seed = 1
        self._iter_mesh_cache = None

    # ------------------------------------------------------------------
    # config plumbing: option surface as mutable attributes
    # ------------------------------------------------------------------

    def __setattr__(self, name, value):
        if name in _CFG_FIELDS:
            self._overrides[name] = value
            object.__setattr__(self, "_cfg_cache", None)
        else:
            object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        if name in _CFG_FIELDS:
            return getattr(self.cfg, name)
        raise AttributeError(name)

    @property
    def cfg(self) -> GpConfig:
        if self._cfg_cache is None:
            ov = dict(self._overrides)
            for rng in ("hp_theta_range", "hp_varK_range", "hp_var_fval_range",
                        "hp_var_fgrad_range"):
                if rng in ov:
                    ov[rng] = tuple(ov[rng])
            cfg = GpConfig(**ov)
            object.__setattr__(self, "_cfg_cache", cfg)
        return self._cfg_cache

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.cfg)

    def _tensor(self, v, dtype=None):
        return torch.as_tensor(np.asarray(v), dtype=dtype or self.dtype,
                               device=self.device)

    @property
    def cfg_predict(self) -> GpConfig:
        """The config of the closed form and the predict: with the polish
        on, f64 at ``polish_cond_target`` whatever the main fit's dtype.
        The JAX package also turns Pallas off here; the port keeps K1/K2,
        which compute the same function in f64."""
        cfg = self.cfg
        if cfg.polish_cond_target:
            return dataclasses.replace(
                cfg, dtype="float64", cond_max_target=cfg.polish_cond_target)
        return cfg

    @property
    def _predict_dtype(self) -> torch.dtype:
        """The dtype query points are cast to: the predict's own (casting
        them to an f32 fit dtype would truncate each coordinate before the
        f64 predict)."""
        if self.cfg.solver == "iterative":
            return self.dtype
        return predict._predict_dtype(self.cfg_predict)

    def _eta_for_predict(self) -> float:
        """The predict's nugget: at the polish target when the polish is
        on."""
        if self.cfg.polish_cond_target:
            return float(conditioning.calc_etaK(self.cfg_predict, self.n_eval))
        return float(self._etaK)

    @property
    def b_use_cond_cstr(self):
        return self.cfg.b_use_cond_cstr

    @property
    def b_use_data_scl(self):
        return self.cfg.b_use_data_scl

    @property
    def b_has_noisy_data(self):
        return None if self.spec is None else self.spec.b_has_noisy_data

    @property
    def n_data(self):
        return self.spec.n_data

    @property
    def n_beta_coeff(self):
        return self.cfg.n_beta_coeff

    # ------------------------------------------------------------------
    # data ingestion
    # ------------------------------------------------------------------

    def set_data(self, x_eval, fval, std_fval=None, grad=None, std_grad=None,
                 bvec_use_grad=None):
        cfg = self.cfg
        x_eval = np.asarray(x_eval, float)
        fval = np.atleast_1d(np.asarray(fval, float)).ravel()
        n_eval = fval.size
        assert x_eval.ndim == 2, "x_eval must be a 2D array"
        assert x_eval.shape[0] == n_eval, "x_eval/fval size mismatch"
        if grad is not None:
            grad = np.asarray(grad, float)
            assert cfg.use_grad, "grad provided but use_grad is False"
        else:
            assert not cfg.use_grad, "use_grad is True but no grad provided"

        if std_fval is not None and np.any(np.isnan(std_fval)):
            std_fval = None
        if std_grad is not None and np.any(np.isnan(std_grad)):
            std_grad = None

        self.n_eval = n_eval
        self._x_eval_in = x_eval
        self._fval_in = fval
        self._std_fval_in = None if std_fval is None else np.asarray(std_fval, float).ravel()
        self._grad_in = grad
        self._std_grad_in = None if std_grad is None else np.asarray(std_grad, float)
        self.bvec_use_grad = bvec_use_grad

        n_pad = 0
        # the iterative path keeps its own full layout: no shape bucketing
        if cfg.pad_n_eval_multiple > 1 and cfg.solver != "iterative":
            n_pad = (-n_eval) % cfg.pad_n_eval_multiple
        if cfg.solver == "dense_dist":
            # pad n_data_tot onto the world_size * dist_chol_block grid of
            # the distributed Cholesky: a padding point adds one identity
            # row (a value row, no gradient rows), masked like bucket
            # padding, on top of any bucket padding (api.py:281-296 of the
            # JAX package, whose grid is the device count's)
            if bvec_use_grad is None:
                n_grad_rows = cfg.dim * n_eval if cfg.use_grad else 0
            else:
                n_grad_rows = cfg.dim * int(
                    np.count_nonzero(np.asarray(bvec_use_grad)))
            grid = self._iter_mesh().size * cfg.dist_chol_block
            n_pad += (-(n_eval + n_grad_rows + n_pad)) % grid
        self.spec = make_data_spec(cfg.dim, cfg.use_grad, n_eval,
                                   std_fval=self._std_fval_in,
                                   std_grad=self._std_grad_in,
                                   bvec_use_grad=bvec_use_grad,
                                   n_pad_eval=n_pad)
        self.n_grad = self.spec.n_grad

        self._eta_Kbase, self._eta_Kgrad = conditioning.calc_nugget(cfg, n_eval)
        self._etaK = self._eta_Kgrad if cfg.use_grad else self._eta_Kbase
        self._vmin_init = (float(rtensor.calc_dist_min(torch.as_tensor(x_eval)))
                           if n_eval > 1 else np.nan)
        self.hp_info_optz_lkd = self.set_hp_optz_info()

        # rescaling frame of the rescaling methods
        if cfg.b_use_data_scl:
            if cfg.wellcond_mtd == "rescale_origin":
                dist_set = conditioning.calc_mtd_rescale_origin_vreq(n_eval,
                                                                     cfg.dim)
                self._vmin_req_grad = dist_set
                method = "set_vmin"
            elif cfg.wellcond_mtd == "rescale_eta_vary":
                dist_set, method = cfg.vmin_rescale_eta_vary, "set_vmin"
            elif cfg.wellcond_mtd == "dflt_vmin":
                dist_set, method = cfg.cond_dist_min_dflt, "set_vmin"
            else:  # dflt_vmax
                dist_set, method = cfg.cond_dist_max_dflt, "set_vmax"
            self.DataScl = rescale.Rescaling(x_eval, x_scl_method=method,
                                             dist_set=dist_set)
            self.DataScl.set_obj_data(fval, self._std_fval_in, grad,
                                      self._std_grad_in)
        else:
            self.DataScl = None

        self._refresh_core_data()
        self._eval_state = None

    def _refresh_core_data(self):
        """Build the device-resident GpData in the working (scaled) frame;
        padding points are appended after the frame transform."""
        if self.DataScl is not None:
            x = self.DataScl.get_scl_x()
            f, std_f, g, std_g = self.DataScl.get_scl_obj_data()
        else:
            x, f = self._x_eval_in, self._fval_in
            std_f, g, std_g = (self._std_fval_in, self._grad_in,
                               self._std_grad_in)
        n_pad = self.spec.n_pad_eval
        if n_pad:
            x = np.concatenate([x, np.tile(x[:1], (n_pad, 1))])
            f = np.concatenate([f, np.zeros(n_pad)])
            if std_f is not None:
                std_f = np.concatenate([std_f, np.zeros(n_pad)])
        self.data = GpData(
            x=self._tensor(x), fval=self._tensor(f),
            std_fval=None if std_f is None else self._tensor(std_f),
            grad=None if g is None else self._tensor(g),
            std_grad=None if std_g is None else self._tensor(std_g))

    # ------------------------------------------------------------------
    # hyperparameter containers
    # ------------------------------------------------------------------

    def make_hp_class(self, beta=None, theta=None, kernel=None, varK=None,
                      var_fval=None, var_fgrad=None) -> Hypers:
        def arr(v):
            return None if v is None else self._tensor(v)
        return Hypers(beta=arr(beta), theta=arr(theta), kernel=arr(kernel),
                      varK=arr(varK), var_fval=arr(var_fval),
                      var_fgrad=arr(var_fgrad))

    def set_custom_hp(self, beta=None, theta=None, kernel=None, varK=None,
                      var_fval=None, var_fgrad=None):
        if varK is not None:
            assert varK > 0, f"varK must be positive but it is {varK}"
        self.hp_vals = self.make_hp_class(beta, theta, kernel, varK,
                                          var_fval, var_fgrad)

    def hp_vec2dataclass(self, hp_optz_info: HpInfo, hp_vec) -> Hypers:
        return hp_vec_to_hypers(hp_optz_info, self._tensor(hp_vec))

    def set_hp_from_idx(self, i_optz: int):
        h = self.history
        assert h is not None, "init_optz_surr must be called first"
        var_fval = h.hp_var_fval[i_optz]
        var_fgrad = h.hp_var_fgrad[i_optz]
        self.hp_vals = self.make_hp_class(
            h.hp_beta[i_optz], h.hp_theta[i_optz],
            None if np.isnan(h.hp_kernel[i_optz]) else h.hp_kernel[i_optz],
            h.hp_varK[i_optz],
            None if np.isnan(var_fval) else var_fval,
            None if np.isnan(var_fgrad) else var_fgrad)

    def set_hp_optz_info(self) -> HpInfo:
        """Index layout of the numerically optimized hyperparameters."""
        cfg, spec = self.cfg, self.spec
        return HpInfo(dim=cfg.dim,
                      has_theta=True,
                      has_kernel=cfg.b_optz_hp_kernel and cfg.kernel_has_hp,
                      has_varK=spec.b_has_noisy_data,
                      has_var_fval=spec.b_optz_var_fval,
                      has_var_fgrad=spec.b_optz_var_fgrad,
                      log_theta=cfg.optz_log_hp_theta,
                      log_kernel=cfg.optz_log_hp_kernel,
                      log_var=cfg.optz_log_hp_var)

    setup_hp_idx4optz = set_hp_optz_info

    def get_init_hp_vals(self) -> Hypers:
        """Initial hyperparameters used while n_eval <= hp_const_n_eval.
        beta[0] is the mean of the working frame's values (scaled under a
        rescaling method), padding zeros included, as in the JAX
        package."""
        cfg, spec = self.cfg, self.spec
        theta = cfg.hp_theta_init * np.ones(cfg.dim)
        beta = np.zeros(cfg.n_beta_coeff)
        beta[0] = float(np.mean(self.data.fval.cpu().numpy()))
        var_fval = None if spec.known_eps_fval else cfg.hp_var_fval_init
        var_fgrad = (None if (not cfg.use_grad or spec.known_eps_fgrad)
                     else cfg.hp_var_fgrad_init)
        return self.make_hp_class(beta, theta, cfg.hp_kernel_default,
                                  cfg.hp_varK_init, var_fval, var_fgrad)

    # ------------------------------------------------------------------
    # likelihood entry point
    # ------------------------------------------------------------------

    def calc_lkd_all(self, hp_vals: Hypers, calc_lkd=True, calc_cond=False,
                     calc_grad=False):
        """Returns (LkdInfo, b_chofac_good)."""
        with torch.no_grad():
            lkd = likelihood.calc_lkd(self.cfg, self.spec, self.data, hp_vals,
                                      float(self._etaK), calc_cond=calc_cond)
        return lkd, bool(lkd.ok)

    # ------------------------------------------------------------------
    # training (set_hpara / optz_hp)
    # ------------------------------------------------------------------

    def init_optz_surr(self, n_optz_max: int):
        self.history = FitHistory(n_optz_max, self.cfg.dim,
                                  self.cfg.n_beta_coeff)

    def finish_optz_surr(self, n_optz_final: int):
        assert self.history is not None
        self.history.finish(n_optz_final)

    def export_data_surr(self, save2file=True, file2save=None):
        assert self.history is not None
        path = (file2save or self.path_surr_npz) if save2file else None
        return self.history.export(path or "", self.surr_name) \
            if path else self.history.to_dict(self.surr_name)

    def load_data_surr(self, all_data=None, path=None):
        assert self.history is not None
        self.history.load(all_data if all_data is not None
                          else (path or self.path_surr_npz), self.surr_name)

    def store_new_para_surr(self, i_optz, hp_vals, surr_optz_info=None,
                            cond_val=np.nan, time_hp_optz=np.nan,
                            time_chofac=np.nan, time_pick_hp0=np.nan,
                            ln_lkd=np.nan):
        self.hp_vals = hp_vals
        if self.history is None:
            return
        self.history.store(
            i_optz, Hypers(**convert.hypers_to_numpy(hp_vals)), surr_optz_info,
            cond_val, self.cfg.cond_max, self._eta_Kbase, self._eta_Kgrad,
            self.cfg.use_grad, self._vmin_init, self._vmin_req_grad,
            None if self.DataScl is None else self.DataScl.xvec_scale,
            self._fval_in, ln_lkd, time_hp_optz, time_chofac, time_pick_hp0)

    def optz_hp(self, i_optz: int):
        """One hyperparameter-training round."""
        cfg = self.cfg
        self.optz_infos = []
        if self.n_eval <= cfg.hp_const_n_eval:
            hp_vals = self.get_init_hp_vals()
            lkd, _ = self.calc_lkd_all(hp_vals, calc_cond=True)
            self.store_new_para_surr(i_optz, hp_vals, None, float(lkd.cond))
            return

        t0 = time.time()
        if "rescale" in cfg.wellcond_mtd and cfg.cond_vreq_max_iter > 1:
            fit = self._optz_hp_rescale_loop(i_optz)
        else:
            fit = self._run_fit(i_optz)
        if cfg.polish_cond_target:
            fit = self._polish_fit(fit, i_optz)
        t_optz = time.time() - t0
        hp_vals = hp_vec_to_hypers(
            self.hp_info_optz_lkd,
            self._tensor(fit.hp_vec, _torch_dtype(self.cfg_predict)))
        hp_vals = self._closed_form(hp_vals)
        self.store_new_para_surr(i_optz, hp_vals, fit.info, float(fit.cond),
                                 t_optz, self._time_chofac_last,
                                 ln_lkd=-float(fit.neg_lkd))

    def _iter_mesh(self):
        """The mesh of the sharded matvec and the distributed Cholesky (or
        None): every rank of the process group, on the model's device,
        made once per facade."""
        if not (self.cfg.iter_use_mesh or self.cfg.solver == "dense_dist"):
            return None
        if self._iter_mesh_cache is None:
            self._iter_mesh_cache = pmesh.make_mesh(device=self.device)
        return self._iter_mesh_cache

    def _iter_kw(self) -> dict:
        """The iterative solver's options and mesh."""
        return dict(iterative_driver.iter_kw(self.cfg),
                    mesh=self._iter_mesh())

    def _run_fit(self, i_optz, x0_override=None):
        cfg = self.cfg
        if cfg.solver == "iterative":
            fit = iterative_driver.fit_map_iterative(
                cfg, self.spec, self.hp_info_optz_lkd, self.data,
                float(self._etaK), history=self.history, i_optz=i_optz,
                seed=self._fit_seed, x0_override=x0_override,
                mesh=self._iter_mesh())
            self.optz_infos.append(fit.info)
            return fit
        if cfg.solver == "dense_dist":
            fit = dense_dist_driver.fit_map_dense_dist(
                cfg, self.spec, self.hp_info_optz_lkd, self.data,
                float(self._etaK), history=self.history, i_optz=i_optz,
                seed=self._fit_seed, x0_override=x0_override,
                mesh=self._iter_mesh(), hp_prev=self._prev_hp_vec())
            self.optz_infos.append(fit.info)
            return fit
        use_scipy = (cfg.optz_mtd in ("slsqp", "SLSQP", "trust-constr")
                     or cfg.b_use_cond_cstr)
        fitter = scipy_driver.fit_map_scipy if use_scipy else multistart.fit_map
        fit = fitter(cfg, self.spec, self.hp_info_optz_lkd, self.data,
                     float(self._etaK), history=self.history, i_optz=i_optz,
                     seed=self._fit_seed, x0_override=x0_override,
                     hp_prev=self._prev_hp_vec())
        self.optz_infos.append(fit.info)
        return fit

    def _polish_fit(self, fit, i_optz):
        """Warm single-start f64 re-fit at ``polish_cond_target``
        (api.py:574-592 of the JAX package): the f32 fit at its looser
        target finds the basin, ``polish_iter_max`` f64 L-BFGS iterations
        at the tight target finish it.  No final condition number: the
        main fit's cond and telemetry are kept (the polish's telemetry is
        appended to ``optz_infos``)."""
        cfgp = dataclasses.replace(self.cfg_predict,
                                   optz_iter_max=self.cfg.polish_iter_max)
        fit2 = multistart.fit_map(
            cfgp, self.spec, self.hp_info_optz_lkd,
            cast_float_tree(self.data, torch.float64),
            float(conditioning.calc_etaK(cfgp, self.n_eval)),
            history=self.history, i_optz=i_optz,
            x0_override=np.asarray(fit.hp_vec, np.float64)[None, :],
            with_cond=False)
        self.optz_infos.append(dict(fit2.info, polish=True))
        return fit2._replace(cond=fit.cond, info=fit.info)

    def _optz_hp_rescale_loop(self, i_optz):
        """The rescale fixed-point loop (api.py:595-633 of the JAX package):
        fit, rescale x so that theta's spread shrinks, refit warm-started
        from the previous optimum, up to cond_vreq_max_iter times; then keep
        the scaling whose theta spread was least, with its estimated
        theta."""
        cfg = self.cfg
        fit = self._run_fit(i_optz)
        if self.n_eval <= 1:
            return fit

        max_iter = cfg.cond_vreq_max_iter
        theta_all = np.full((max_iter, cfg.dim), np.nan)
        dist_all = np.full(max_iter, np.nan)
        scale_all = np.full((max_iter, cfg.dim), np.nan)

        best_hp = np.asarray(fit.hp_vec)
        theta_new = best_hp[:cfg.dim]          # log10 theta
        cnt = 0
        while True:
            theta_new, est_dist, xvec_new = self._rescale_w_theta_sol(theta_new)
            theta_all[cnt] = theta_new
            dist_all[cnt] = est_dist
            scale_all[cnt] = xvec_new
            if cnt == max_iter - 1 or est_dist < cfg.cond_vreq_iter_tol:
                break
            # the next inner fit starts from the previous best hp with the
            # rescaled theta
            warm = best_hp.copy()
            warm[:cfg.dim] = theta_new
            fit = self._run_fit(i_optz, x0_override=warm[None, :])
            best_hp = np.asarray(fit.hp_vec)
            theta_new = best_hp[:cfg.dim]
            cnt += 1

        idx = int(np.nanargmin(dist_all))
        self.DataScl.set_xscale_data(xvec_scale_in=scale_all[idx])
        self._refresh_core_data()
        final_hp = best_hp.copy()
        final_hp[:cfg.dim] = theta_all[idx]
        return fit._replace(hp_vec=final_hp)

    def _rescale_w_theta_sol(self, hp_theta_log):
        """New x scaling from a fitted theta (api.py:635-661 of the JAX
        package): -> (estimated theta in optimization space, spread of log10
        theta, new xvec_scale)."""
        cfg = self.cfg
        if cfg.optz_log_hp_theta:
            theta_sol = 10.0 ** np.asarray(hp_theta_log)
            log_theta = np.asarray(hp_theta_log)
        else:
            theta_sol = np.asarray(hp_theta_log)
            log_theta = np.log10(theta_sol)
        vreq = conditioning.calc_mtd_rescale_origin_vreq(self.n_eval, cfg.dim)

        x_scl = self.DataScl.get_scl_x()
        xvec_scale_v1 = self.DataScl.xvec_scale
        theta_star = 10.0 ** np.mean(log_theta)
        xvec_v2 = np.sqrt(theta_sol / theta_star)
        x_v2 = x_scl * xvec_v2[None, :]
        d2 = np.sqrt(np.sum((x_v2[:, None] - x_v2[None, :]) ** 2, -1))
        np.fill_diagonal(d2, np.inf)
        min_dist = max(float(d2.min()), 1e-15)
        correction = vreq / min_dist
        xvec_new = xvec_scale_v1 * xvec_v2 * correction

        dist2 = (np.dot(log_theta, log_theta)
                 - np.dot(log_theta, np.ones(cfg.dim)) ** 2 / cfg.dim)
        theta_est = np.ones(cfg.dim) * theta_star / correction ** 2
        theta_out = (np.log10(theta_est) if cfg.optz_log_hp_theta else theta_est)
        return theta_out, dist2, xvec_new

    def _prev_hp_vec(self):
        """Previous round's converged hp as an optimization-space vector (or
        None), guarded against layout changes and non-finite leftovers."""
        if self.hp_vals is None:
            return None
        try:
            v = hypers_to_hp_vec(self.hp_info_optz_lkd, self.hp_vals)
        except (TypeError, ValueError, RuntimeError):
            return None
        v = v.detach().cpu().numpy().astype(float)
        if v.size != self.hp_info_optz_lkd.n_hp or not np.all(np.isfinite(v)):
            return None
        return v

    def _closed_form(self, hp_vals: Hypers) -> Hypers:
        t0 = time.time()
        with torch.no_grad():
            if self.cfg.solver == "iterative":
                out = likelihood_iter.closed_form_iterative(
                    self.cfg, self.spec, self.data, hp_vals,
                    float(self._etaK), **self._iter_kw())
            else:
                # at the predict's precision and conditioning: beta and varK
                # feed the surrogate, so under the polish they come from
                # the f64 covariance at the polish target
                cfgp = self.cfg_predict
                dt = _torch_dtype(cfgp)
                lkd = likelihood.calc_lkd(
                    cfgp, self.spec, cast_float_tree(self.data, dt),
                    cast_float_tree(hp_vals, dt), self._eta_for_predict())
                varK = (hp_vals.varK if self.spec.b_has_noisy_data
                        else lkd.varK)
                out = hp_vals._replace(beta=lkd.beta, varK=varK)
        _sync(self.device)
        # one assembly + factorization (or one batched CG) at the final hp
        self._time_chofac_last = time.time() - t0
        self._time_chofac += self._time_chofac_last
        return out

    def set_hpara(self, method2set_hp: str, i_optz: int, hp_vals=None,
                  calc_cond: bool = False):
        assert isinstance(method2set_hp, str)
        if method2set_hp == "stored":
            assert i_optz >= 0
            self.set_hp_from_idx(i_optz)
        elif method2set_hp == "optz":
            self.optz_hp(i_optz)
        elif method2set_hp == "current":
            assert self.hp_vals is not None
        elif method2set_hp == "set":
            assert hp_vals is not None
            self.hp_vals = hp_vals
        else:
            raise ValueError(f"Unknown method2set_hp = {method2set_hp}")
        if self.hp_vals.beta is None or self.hp_vals.varK is None:
            self.hp_vals = self._closed_form(self.hp_vals)
        self.setup_eval_model(calc_cond=calc_cond)

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------

    def setup_eval_model(self, calc_cond: bool = False):
        assert self.hp_vals is not None, "hyperparameters not set"
        self._hp_vals_model_setup = self.hp_vals
        if self.cfg.solver == "iterative":
            # no factorization to probe for a condition number; the CG
            # residual and iterations live on the state instead
            with torch.no_grad():
                self._eval_state = predict_iter.setup_eval_iterative(
                    self.cfg, self.spec, self.data, self.hp_vals,
                    float(self._etaK), **self._iter_kw())
            self.condK = None
            return
        with torch.no_grad():
            self._eval_state = predict.setup_eval(
                self.cfg_predict, self.spec, self.data, self.hp_vals,
                self._eta_for_predict(), calc_cond=calc_cond)
        self.condK = float(self._eval_state.cond) if calc_cond else None

    def _check_eval_ready(self):
        assert self._eval_state is not None, \
            "setup_eval_model() must be called before eval_model()"
        assert self.hp_vals is self._hp_vals_model_setup, \
            "Cannot change hp_vals between setup_eval_model() and eval_model()"

    def _query(self, x2model_in, squeeze_nx):
        """Query points (init frame, host) -> working-frame tensor of the
        predict's dtype."""
        self._check_eval_ready()
        xq = np.atleast_2d(np.asarray(x2model_in, float))
        if squeeze_nx:
            assert xq.shape[0] == 1
        if self.DataScl is not None:
            xq = self.DataScl.x_init_2_scl(xq)
        return self._tensor(xq, self._predict_dtype)

    def _eval_iterative(self, xq, calc_grad):
        """(mu, sig, dmudx, dsigdx) of the iterative solver at the
        working-frame tensor xq."""
        with torch.no_grad():
            return predict_iter.eval_model_iterative(
                self.cfg, self.spec, self.data, self._eval_state,
                float(self._etaK), xq, calc_sig=True, calc_grad=calc_grad,
                **self._iter_kw())

    @staticmethod
    def _squeeze(vals, squeeze_nx):
        if squeeze_nx:
            vals = [None if v is None else v[0] for v in vals]
        return tuple(vals)

    def eval_model(self, x2model_in, calc_grad=False, calc_hess=False,
                   squeeze_nx=False):
        if calc_hess:
            assert calc_grad, "calc_hess requires calc_grad"
        xq = self._query(x2model_in, squeeze_nx)
        if self.cfg.solver == "iterative":
            if calc_hess:
                raise NotImplementedError(_NO_HESS)
            out = (*self._eval_iterative(xq, calc_grad), None, None)
        else:
            with torch.no_grad():
                out = predict.eval_model(self.cfg_predict, self.spec,
                                         self.data, self._eval_state, xq,
                                         calc_grad=calc_grad,
                                         calc_hess=calc_hess)
        out = [None if v is None else v.cpu().numpy() for v in out]
        if self.DataScl is not None:
            out = self.DataScl.obj_scl_2_init(*out)
        return self._squeeze(out, squeeze_nx)

    def eval_model_var(self, x2model_in, calc_grad=False, calc_hess=False,
                       squeeze_nx=False):
        """Variance (not std) and its derivatives.  Under a rescaling frame
        var_init = var_scl / obj_scale^2 with a 1/xvec_scale factor per
        x-derivative, as in the JAX package."""
        xq = self._query(x2model_in, squeeze_nx)
        if self.cfg.solver == "iterative":
            if calc_hess:
                raise NotImplementedError(_NO_HESS)
            _, sig, _, dsig = self._eval_iterative(xq, calc_grad)
            out = (sig ** 2, None if dsig is None else 2.0 * sig[:, None] * dsig,
                   None)
        else:
            with torch.no_grad():
                out = predict.eval_model_var(self.cfg_predict, self.spec,
                                             self.data, self._eval_state, xq,
                                             calc_grad=calc_grad,
                                             calc_hess=calc_hess)
        out = [None if v is None else v.cpu().numpy() for v in out]
        if self.DataScl is not None:
            s = self.DataScl
            o2 = s.obj_scale ** 2
            if out[0] is not None:
                out[0] = out[0] / o2
            if out[1] is not None:
                out[1] = out[1] * (s.xvec_scale[None, :] / o2)
            if out[2] is not None:
                out[2] = out[2] * (np.outer(s.xvec_scale, s.xvec_scale)[None]
                                   / o2)
        return self._squeeze(out, squeeze_nx)

    def make_predict_fn(self, calc_grad: bool = False,
                        calc_hess: bool = False):
        """Serving path: a callable ``xq -> (mu, sig, dmudx, dsigdx,
        d2mudx2, d2sigdx2)`` (tensors on the model's device, None where not
        computed) that closes over the device-resident state of the current
        model, so a query costs no setup.  No rescaling frames (use
        eval_model there), as in the JAX package."""
        self._check_eval_ready()
        if self.DataScl is not None:
            raise ValueError("make_predict_fn: no rescaling frames")
        cfg, spec, data, state = self.cfg, self.spec, self.data, self._eval_state
        dtype, device, eta = self._predict_dtype, self.device, float(self._etaK)

        def query(xq):
            return torch.atleast_2d(torch.as_tensor(xq, dtype=dtype,
                                                    device=device))

        if cfg.solver == "iterative":
            if calc_hess:
                raise NotImplementedError(_NO_HESS)
            kw = self._iter_kw()

            def predict_i(xq):
                with torch.no_grad():
                    mu, sig, dmu, dsig = predict_iter.eval_model_iterative(
                        cfg, spec, data, state, eta, query(xq), calc_sig=True,
                        calc_grad=calc_grad, **kw)
                return mu, sig, dmu, dsig, None, None

            return predict_i

        cfgp = self.cfg_predict

        def predict_d(xq):
            with torch.no_grad():
                return predict.eval_model(cfgp, spec, data, state, query(xq),
                                          calc_grad=calc_grad,
                                          calc_hess=calc_hess)

        return predict_d

    def calc_model_mean_w_data_init(self, x2model_init, fval_init,
                                    grad_init=None, calc_grad: bool = True):
        """Posterior mean (and its x-gradient) with the CURRENT
        factorization and hyperparameters but another data vector, as in
        the JAX package: the query points and data are mapped into the
        rescaling frame, then ``calc_model_mean_w_data_scl``."""
        self._check_eval_ready()
        xq = np.atleast_2d(np.asarray(x2model_init, float))
        fval = np.asarray(fval_init, float)
        if self.DataScl is not None:
            xq_s = self.DataScl.x_init_2_scl(xq)
            fval_s, _, grad_s, _ = self.DataScl.obj_init_2_scl(
                fval, None, grad_init, None)[:4]
        else:
            xq_s, fval_s, grad_s = xq, fval, grad_init
        return self.calc_model_mean_w_data_scl(xq_s, fval_s, grad_s,
                                               calc_grad=calc_grad)

    def calc_model_mean_w_data_scl(self, x2model_scl, fval_scl,
                                   grad_scl=None, calc_grad: bool = True):
        """Scaled-frame twin of ``calc_model_mean_w_data_init``: query points
        and data are already in the rescaling frame; mu (and dmu/dx) come
        back in the init frame.  Without a rescaling the frames coincide.
        Uses the cached factorization's solve (refined where the predict
        refines) and the predictor's cross covariance on the model's
        device, at the predict's precision; returns numpy arrays."""
        self._check_eval_ready()
        cfg, spec, state = self.cfg_predict, self.spec, self._eval_state
        hp, dt = state.hp, self._predict_dtype
        x = self.data.x.to(dt)
        xq = self._tensor(np.atleast_2d(np.asarray(x2model_scl, float)), dt)
        with torch.no_grad():
            data_vec = rtensor.make_data_vec(
                self._tensor(np.asarray(fval_scl, float), dt),
                None if grad_scl is None else self._tensor(grad_scl, dt))
            vand = mean.calc_aug_vand(cfg.mean_fun_type, x, spec.use_grad,
                                      spec.idx_grad_arr)
            sol = predict._ops_solve(cfg, state.ops,
                                     data_vec - vand @ hp.beta)
            Kyx, dKxy_dx = predict._cross_cov(cfg, spec, x, xq, hp)
            mval, mgrad, _ = mean.eval_mean_fun(cfg.mean_fun_type, xq,
                                                hp.beta)
            mu = (mval + Kyx.T @ sol).cpu().numpy()
            dmu = None
            if calc_grad:
                nx, dim = xq.shape
                dmu = ((dKxy_dx @ sol).reshape(dim, nx).T
                       + mgrad).cpu().numpy()
        if self.DataScl is not None:
            mu, _, dmu = self.DataScl.obj_scl_2_init(mu, None, dmu)[:3]
        return mu, dmu

    # ------------------------------------------------------------------
    # frames / data access
    # ------------------------------------------------------------------

    def get_scl_x_w_dist(self):
        return (self.data.x.cpu().numpy(),
                rtensor.calc_rtensor(self.data.x, self.data.x).cpu().numpy())

    def x_init_2_scl(self, x):
        return x if self.DataScl is None else self.DataScl.x_init_2_scl(x)

    def x_scl_2_init(self, x):
        return x if self.DataScl is None else self.DataScl.x_scl_2_init(x)

    def get_init_eval_data(self):
        return self._fval_in, self._std_fval_in, self._grad_in, self._std_grad_in

    def get_scl_eval_data(self):
        if self.DataScl is None:
            return self.get_init_eval_data()
        return self.DataScl.get_scl_obj_data()

    def data_init_2_scl(self, *args, **kw):
        if self.DataScl is None:
            return args if args else None
        return self.DataScl.obj_init_2_scl(*args, **kw)

    def data_scl_2_init(self, *args, **kw):
        if self.DataScl is None:
            return args if args else None
        return self.DataScl.obj_scl_2_init(*args, **kw)

    # ------------------------------------------------------------------
    # Bayesian hyperparameter posteriors
    # ------------------------------------------------------------------

    def _posterior_setup(self, n_chains: int, seed: int):
        """The NUTS target and the chains' starts of ``sample_posterior``:
        (logpost, z_to_hp, z0 (n_chains, n_hp)).  The starts are the
        current hyperparameters (or zeros in z) plus 0.1 x normal jitter,
        drawn for all chains from the shared stream of ``Draws(seed)``."""
        cfg, spec, info = self.cfg, self.spec, self.hp_info_optz_lkd
        bounds = multistart.get_hp_bounds(cfg, info, self.history, 0)
        logpost, z_to_hp, hp_to_z = nuts.make_gp_logpost(
            cfg, spec, info, self.data, float(self._etaK), bounds.box_lb,
            bounds.box_ub)
        if self.hp_vals is not None and self.hp_vals.theta is not None:
            z_init = hp_to_z(hypers_to_hp_vec(info, self.hp_vals).to(
                self.dtype))
        else:
            z_init = torch.zeros(info.n_hp, dtype=self.dtype,
                                 device=self.device)
        z0 = z_init[None, :] + 0.1 * Draws(seed, self.device).normal(
            (n_chains, info.n_hp), self.dtype)
        return logpost, z_to_hp, z0

    def sample_posterior(self, n_chains: int = 8, n_warmup: int = 400,
                         n_samples: int = 400, max_depth: int = 8,
                         seed: int = 0, use_mesh: bool = False):
        """NUTS posterior over the numerically optimized hyperparameters
        (box-uniform prior on the optimization-space vector within the
        current bounds), all chains batched on the model's device with
        per-chain adaptation.  Every draw comes from counter-based streams
        seeded with ``seed``, one per chain.  With ``use_mesh`` the chains
        are split over the ranks of the process group
        (``parallel.mesh.run_nuts_sharded``; n_chains divisible by the world
        size) and adapt on statistics pooled over all chains, as in the JAX
        package.  Returns (hp_samples (chains, samples, n_hp) in VALUE
        space, diagnostics dict of numpy arrays), the same on every rank."""
        logpost, z_to_hp, z0 = self._posterior_setup(n_chains, seed)
        kw = dict(n_warmup=n_warmup, n_samples=n_samples, max_depth=max_depth)
        if use_mesh:
            zs, diag = pmesh.run_nuts_sharded(
                logpost, z0, seed, pmesh.make_mesh(device=self.device), **kw)
        else:
            zs, diag = nuts.run_nuts(logpost, z0, Draws(seed, self.device),
                                     **kw)
        hp_vals = z_to_hp(zs).cpu().numpy()
        bvec = self.hp_info_optz_lkd.bvec_log
        hp_vals[..., bvec] = 10.0 ** hp_vals[..., bvec]
        return hp_vals, {k: v.cpu().numpy() for k, v in diag.items()}

    # ------------------------------------------------------------------
    # observability (utils/info.py renders the tables)
    # ------------------------------------------------------------------

    def get_txt_info_surr(self, i_max: Optional[int] = None) -> str:
        from .utils.info import get_txt_info_surr
        return get_txt_info_surr(self, i_max)

    def plt_debug_lkd(self, i_optz=0, dims=(0, 1), n_grid=10, hp_x0=None,
                      hp_optz=None, path=None, show=False):
        """Normalized negative-MLL contours over two hyperparameters with
        the starts and the optimum overlaid; the whole grid is one batched
        evaluation (utils/lkd_contour.py).  Needs matplotlib."""
        from .utils.lkd_contour import plt_debug_lkd as _plt
        return _plt(self, i_optz=i_optz, dims=dims, n_grid=n_grid,
                    hp_x0=hp_x0, hp_optz=hp_optz, path=path, show=show)

