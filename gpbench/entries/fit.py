"""Independent hyperparameter fits, closed loop, one caller.

Request k refits the GP on the first n_eval points of a recorded BO run:
``GaussianProcess(...)`` -> ``set_data`` -> ``set_hpara("optz", 0)``,
ending in a synchronize.  n_eval cycles over the traffic's sizes in a
fixed order; the seed draws each request's run and multistart seed.

Judged after the window, every completed fit: the reference's -ln L at the
program's theta against the one the optimizer reported, the closed-form
varK and beta, and the projected gradient.  Under ``rescale_origin`` the
reference works out the rescale loop's frames from the raw points and
each inner fit's theta, judges each inner fit in its frame (its
stationarity is the KKT residual under cond(M) <= cond_max, and
cond_excess how far cond(M) lies above cond_max), and judges the
program's frames against its own (vreq_rel, frame_rel).
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench.entries import common
from gpbench.reference import gp as ref


class Entry(common.Base):

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.method = self.config["wellcond_mtd"]
        self.answers = []

    def request_args(self, k):
        """(run, n_eval, multistart seed) of request k."""
        return common.cycle_request(self.traffic, self.seed, k)

    def setup(self):
        import gpgradpy_torch.ops.cuda_assembly  # noqa: F401  (K1/K2 load)
        # one fit at each size of the cycle
        for n in self.traffic["n_eval"]:
            self.warm(self.fit, *self.problem.data(self.traffic["runs"][0], n),
                      1)
        self.sync()

    def fit_recorded(self, x, f, g, fit_seed):
        """A fit; under the rescale loop each inner fit's frame and answer
        are recorded as the loop produces them."""
        inner = []
        if self.method != "rescale_origin":
            return self.fit(x, f, g, fit_seed), inner
        from gpgradpy_torch import GaussianProcess
        orig = GaussianProcess._run_fit

        def run_fit(gp, *a, **kw):
            res = orig(gp, *a, **kw)
            inner.append({"xvec": np.array(gp.DataScl.xvec_scale, np.float64),
                          "theta": 10.0 ** np.asarray(res.hp_vec, np.float64),
                          "nll": float(res.neg_lkd)})
            return res
        GaussianProcess._run_fit = run_fit
        try:
            gp = self.fit(x, f, g, fit_seed)
        finally:
            GaussianProcess._run_fit = orig
        return gp, inner

    def request(self, k):
        run, n, fit_seed = self.request_args(k)
        x, f, g = self.problem.data(run, n)
        gp, inner = self.fit_recorded(x, f, g, fit_seed)
        self.sync()
        ans = common.fit_answer(gp)
        if inner:
            ans["xvec"] = np.array(gp.DataScl.xvec_scale, np.float64)
        self.answers.append((run, n, ans, inner, gp.optz_infos))

    def install_spans(self, rec):
        import gpgradpy_torch.model.likelihood as lk
        import gpgradpy_torch.ops.linalg as la

        def counted(fn):
            def run(*a, **kw):
                rec.count("lkd_calls")
                return fn(*a, **kw)
            return run

        def ranged(fn):
            def run(*a, **kw):
                with torch.profiler.record_function("gpbench.cond"):
                    return fn(*a, **kw)
            return run
        self.patch(lk, "calc_lkd", counted)
        self.patch(la, "cond_eigh", ranged)
        self.patch(la, "cond_fro_w_chol", ranged)

    def check(self):
        worst = {}
        for run, n, ans, inner, infos in self.answers:
            x, f, g = self.problem.data(run, n)
            if self.method == "rescale_origin":
                vals = self.judge_rescale(x, f, g, ans, inner)
            else:
                vals = common.judge_fit(self, x, f, g, ans, self.method)
            common.log_judged(f"run {run} n_eval {n}", vals, infos)
            for k, v in vals.items():
                worst[k] = max(worst.get(k, 0.0), v if np.isfinite(v)
                               else np.inf)
        return self.checks(worst)

    def judge_rescale(self, x, f, g, ans, inner):
        """The rescaling loop against the reference's.  The reference works
        out the loop's frames from the raw points and the theta of each
        inner fit, and judges each inner fit in its frame: -ln L
        (nll_rel), the KKT residual under cond_fro(M) <= cond_max
        (stationarity), and how far cond_fro(M) lies above cond_max
        (cond_excess).  The program's frames are judged against the
        reference's: the points' least distance against vreq(n, d)
        (vreq_rel), and each scaling vector and the final theta
        (frame_rel).  The closed form is judged at the final frame."""
        facade = self.config["facade"]
        cond_max = float(facade["cond_max"])
        lo, hi = common.theta_box(self.config)
        X0, F0, G0 = (self.ref_tensor(a) for a in (x, f, g))
        vreq = ref.vreq_rescale(*x.shape)
        if inner:
            xvec0, xvec_end, theta_end = ref.rescale_loop_frames(
                X0, [self.ref_tensor(fit["theta"]) for fit in inner])
        else:
            xvec0 = xvec_end = ref.rescale_initial_scale(X0)
            theta_end = None

        def rel(got, want):
            return float(((self.ref_tensor(got) - want).abs()
                          / want.abs()).max())

        def vreq_gap(xvec):
            xs = (X0 - X0[-1]) * self.ref_tensor(xvec)
            return abs(ref.min_distance(xs) - vreq) / vreq

        vals = dict.fromkeys(("nll_rel", "stationarity", "cond_excess",
                              "vreq_rel", "frame_rel"), 0.0)
        X, F, G = ref.rescaled_frame(X0, F0, G0, xvec0)
        for fit in inner:
            lt = torch.log10(self.ref_tensor(fit["theta"]))
            nll, res, cond = ref.kkt_residual(
                X, F, G, lt, "rescale_origin",
                float(facade["cond_max_target"]), cond_max, lo, hi)
            got = {"nll_rel": abs(fit["nll"] - nll) / abs(nll),
                   "stationarity": res / max(1.0, abs(nll)),
                   "cond_excess": max(0.0, cond / cond_max - 1.0),
                   "vreq_rel": vreq_gap(fit["xvec"]),
                   "frame_rel": rel(fit["xvec"], xvec0)}
            for k, v in got.items():
                vals[k] = max(vals[k], v)
            common.log_judged("inner fit", dict(got, nll=nll, cond=cond))
        vals["vreq_rel"] = max(vals["vreq_rel"], vreq_gap(ans["xvec"]))
        vals["frame_rel"] = max(vals["frame_rel"],
                                rel(ans["xvec"], xvec_end))
        if theta_end is not None:
            vals["frame_rel"] = max(vals["frame_rel"],
                                    rel(ans["theta"], theta_end))
        final = common.judge_fit(self, x, f, g, ans, "rescale_origin",
                                 xvec_scale=xvec_end.cpu().numpy())
        vals["closed_rel"] = final["closed_rel"]
        return vals
