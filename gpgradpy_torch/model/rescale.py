"""Affine rescaling of the parameter space and consistent transforms of
objective / constraint data between the 'init' and 'scl' frames.

Copy of ``gpgradpy_tpu/model/rescale.py`` (host-side numpy only), kept here
so that the port imports nothing of the JAX package.  The frame bookkeeping
happens once per training round on the host; the scaled data then goes to
the device.  The scaling maps are
    x_scl = (x_init - x_shift) * xvec_scale
    f_scl = (f_init - obj_shift) * obj_scale
with gradients/Hessians picking up 1/xvec_scale factors per x-derivative.
"""

from __future__ import annotations

import numpy as np


def _dist_min(x):
    n = x.shape[0]
    if n == 1:
        return np.nan
    d = np.sqrt(np.sum((x[:, None] - x[None, :]) ** 2, -1))
    np.fill_diagonal(d, np.nan)
    return np.nanmin(d)


def _dist_max(x):
    n = x.shape[0]
    if n == 1:
        return np.nan
    d = np.sqrt(np.sum((x[:, None] - x[None, :]) ** 2, -1))
    return np.nanmax(d)


class Rescaling:
    """The x, objective, nonlinear-constraint and box/linear-constraint
    frames of one dataset."""

    tol_min_range_obj = 1e-20
    tol_min_dist_x = 1e-14
    vmin_dflt = 1.0
    vmax_dflt = 1.0
    rangeobj_max_dflt = 100.0

    def __init__(self, x_init, idx_xbest=None, use_x_shift=True,
                 x_scl_method=None, dist_set=None):
        assert x_init.ndim == 2
        assert x_scl_method in ("set_vmin", "set_vmax", None)
        self.n_eval, self.dim = x_init.shape
        self.x_init = np.asarray(x_init, float)
        self.idx_xbest = self.n_eval - 1 if idx_xbest is None else idx_xbest
        self.use_x_shift = use_x_shift
        self.x_scl_method = x_scl_method
        self.dist_set = dist_set
        self._obj_data_set = False
        self._nlc_data_set = False
        self.obj_shift = np.nan
        self.obj_scale = np.nan
        self.set_xscale_data()

    # ---- x frame ----

    def x_init_2_scl(self, x):
        x = np.asarray(x, float)
        return (x - self.x_shift) * self.xvec_scale

    def x_scl_2_init(self, x):
        x = np.asarray(x, float)
        return x / self.xvec_scale + self.x_shift

    def dist_init_2_scl(self, d):
        return d * np.mean(self.xvec_scale)

    def dist_scl_2_init(self, d):
        return d / np.mean(self.xvec_scale)

    def set_xscale_data(self, x_shift_in=None, xvec_scale_in=None):
        if x_shift_in is None:
            x_shift = (self.x_init[self.idx_xbest] if self.use_x_shift
                       else np.zeros(self.dim))
        else:
            x_shift = np.atleast_1d(np.asarray(x_shift_in, float))
        if xvec_scale_in is None:
            xvec_scale_in = np.ones(self.dim)
        else:
            xvec_scale_in = np.asarray(xvec_scale_in, float)
            assert np.all(xvec_scale_in > 0)

        x_v1 = (self.x_init - x_shift) * xvec_scale_in
        if self.n_eval == 1 or self.x_scl_method is None:
            coeff = 1.0
        elif self.x_scl_method == "set_vmin":
            dist = self.dist_set if self.dist_set is not None else self.vmin_dflt
            d0 = max(self.tol_min_dist_x, _dist_min(x_v1))
            coeff = dist / d0
        else:  # set_vmax
            dist = self.dist_set if self.dist_set is not None else self.vmax_dflt
            coeff = dist / _dist_max(x_v1)

        self.x_shift = x_shift
        self.xvec_scale = xvec_scale_in * coeff
        self.x_scl = self.x_init_2_scl(self.x_init)
        if self._obj_data_set:
            self._rescale_obj()
        if self._nlc_data_set:
            self._rescale_nlc()

    def get_scl_x(self):
        return self.x_scl

    # ---- objective frame ----

    def set_obj_data(self, obj_init, std_obj_init, grad_init, std_grad_init,
                     use_obj_shift=True, obj_scl_method="dflt_max"):
        self._obj_data_set = True
        self.obj_init = np.asarray(obj_init, float)
        self.std_obj_init = std_obj_init
        self.grad_init = grad_init
        self.std_grad_init = std_grad_init
        self.use_obj_shift = use_obj_shift
        self.obj_scl_method = obj_scl_method

        obj_shift = self.obj_init[self.idx_xbest] if use_obj_shift else 0.0
        if self.obj_init.size == 1 or obj_scl_method is None:
            obj_scale = 1.0
        else:
            rng = max(self.tol_min_range_obj,
                      np.max(self.obj_init) - np.min(self.obj_init))
            obj_scale = self.rangeobj_max_dflt / rng
        self.obj_shift = obj_shift
        self.obj_scale = obj_scale
        self._rescale_obj()

    def _rescale_obj(self):
        self.obj_scl, self.std_obj_scl, self.grad_scl, self.std_grad_scl = \
            self.obj_init_2_scl(self.obj_init, self.std_obj_init,
                                self.grad_init, self.std_grad_init)[:4]

    def obj_init_2_scl(self, mu=None, sig=None, dmudx=None, dsigdx=None,
                       d2mudx2=None, d2sigdx2=None):
        si = 1.0 / self.xvec_scale
        gv = si * self.obj_scale
        hv = si ** 2 * self.obj_scale
        out_mu = None if mu is None else (np.asarray(mu) - self.obj_shift) * self.obj_scale
        out_sig = None if sig is None else np.asarray(sig) * self.obj_scale
        out_dmu = None if dmudx is None else np.asarray(dmudx) * gv
        out_dsig = None if dsigdx is None else np.asarray(dsigdx) * gv
        out_d2mu = None if d2mudx2 is None else np.asarray(d2mudx2) * hv
        out_d2sig = None if d2sigdx2 is None else np.asarray(d2sigdx2) * hv
        return out_mu, out_sig, out_dmu, out_dsig, out_d2mu, out_d2sig

    def obj_scl_2_init(self, mu=None, sig=None, dmudx=None, dsigdx=None,
                       d2mudx2=None, d2sigdx2=None):
        gv = self.xvec_scale / self.obj_scale
        hv = self.xvec_scale ** 2 / self.obj_scale
        out_mu = None if mu is None else np.asarray(mu) / self.obj_scale + self.obj_shift
        out_sig = None if sig is None else np.asarray(sig) / self.obj_scale
        out_dmu = None if dmudx is None else np.asarray(dmudx) * gv
        out_dsig = None if dsigdx is None else np.asarray(dsigdx) * gv
        out_d2mu = None if d2mudx2 is None else np.asarray(d2mudx2) * hv
        out_d2sig = None if d2sigdx2 is None else np.asarray(d2sigdx2) * hv
        return out_mu, out_sig, out_dmu, out_dsig, out_d2mu, out_d2sig

    def get_scl_obj_data(self):
        assert self._obj_data_set
        return self.obj_scl, self.std_obj_scl, self.grad_scl, self.std_grad_scl

    # ---- nonlinear-constraint data ----

    def set_nlc_data(self, nlc_val, nlc_std_val, nlc_grad, nlc_std_grad,
                     use_nlc_shift=False, nlc_scl_method="dflt_max"):
        self._nlc_data_set = True
        self.nlc_val_init = np.asarray(nlc_val, float)
        self.nlc_std_val_init = nlc_std_val
        self.nlc_grad_init = nlc_grad
        self.nlc_std_grad_init = nlc_std_grad
        self.use_nlc_shift = use_nlc_shift
        shift = (self.nlc_val_init[self.idx_xbest] if use_nlc_shift else 0.0)
        rng = np.maximum(self.tol_min_range_obj,
                         np.max(self.nlc_val_init, 0) - np.min(self.nlc_val_init, 0))
        scale = (self.rangeobj_max_dflt / rng if nlc_scl_method == "dflt_max"
                 else np.ones_like(rng))
        self.nlc_shift = shift
        self.nlc_scale = scale
        self._rescale_nlc()

    def _rescale_nlc(self):
        si = 1.0 / self.xvec_scale
        self.nlc_val_scl = (self.nlc_val_init - self.nlc_shift) * self.nlc_scale
        self.nlc_std_val_scl = (None if self.nlc_std_val_init is None
                                else self.nlc_std_val_init * self.nlc_scale)
        if self.nlc_grad_init is None:
            self.nlc_grad_scl = self.nlc_std_grad_scl = None
        else:
            self.nlc_grad_scl = self.nlc_grad_init * self.nlc_scale[None, :, None] * si
            self.nlc_std_grad_scl = (None if self.nlc_std_grad_init is None else
                                     self.nlc_std_grad_init * self.nlc_scale[None, :, None] * si)

    # ---- box / linear constraints ----

    def boxcon_init_2_scl(self, lb, ub):
        return (self.xvec_scale * (np.asarray(lb) - self.x_shift),
                self.xvec_scale * (np.asarray(ub) - self.x_shift))

    def boxcon_scl_2_init(self, lb, ub):
        return (np.asarray(lb) / self.xvec_scale + self.x_shift,
                np.asarray(ub) / self.xvec_scale + self.x_shift)

    def lincon_init_2_scl(self, A, lb, ub):
        """A x in [lb, ub] with x = x_scl/s + shift:
        (A/s) x_scl in [lb - A shift, ub - A shift]."""
        A = np.asarray(A, float)
        shift_term = A @ self.x_shift
        return A / self.xvec_scale[None, :], lb - shift_term, ub - shift_term
