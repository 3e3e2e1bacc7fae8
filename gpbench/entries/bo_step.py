"""BO explore steps, closed loop, one caller.

Request k is one iteration of ``gpgradpy_torch.bo.loop.run_bo`` resumed
from the first n_eval points of a recorded run, with no exploit phase: the
global refit, ``propose_next`` (EI, 16 LHS starts and the best datum) and
the truth evaluation.  n_eval cycles over the traffic's sizes in a fixed
order; the seed draws each step's run and proposal seed.

Judged after the window, every completed step: its refit as a fit entry
judges one, and the acquisition at the proposal: the -EI that the
program's acquisition optimizer reported there against the reference's
-EI at the same point, over the scale of EI's terms |f* - mu| + sig.
"""

from __future__ import annotations

import numpy as np
import torch

from gpbench.entries import common
from gpbench.reference import gp as ref


class Entry(common.Base):

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.steps = []
        self._capture = None

    def request_args(self, k):
        """(run, n_eval, proposal seed) of request k."""
        return common.cycle_request(self.traffic, self.seed, k)

    def setup(self):
        import gpgradpy_torch.ops.cuda_assembly  # noqa: F401  (K1/K2 load)
        self.install_capture()
        for n in self.traffic["n_eval"]:
            self.warm(self.step, self.traffic["runs"][0], n, 0)
        self.sync()

    def install_capture(self):
        """Record each step's answers as run_bo produces them: the refit
        facade and the proposal with the -EI its optimizer reported."""
        from gpgradpy_torch.bo import loop
        from gpgradpy_torch.fit import lbfgs
        cap = {}
        self._capture = cap
        orig_propose = loop.propose_next
        orig_solver = lbfgs.lbfgs_box_multistart

        def propose(gp, lb, ub, fbest, **kw):
            cap["in_propose"] = True
            try:
                x = orig_propose(gp, lb, ub, fbest, **kw)
            finally:
                cap["in_propose"] = False
            cap["gp"], cap["fbest"], cap["x"] = gp, float(fbest), np.array(x)
            return x

        def solver(fun, x0, *a, **kw):
            res = orig_solver(fun, x0, *a, **kw)
            if cap.get("in_propose"):
                f = np.where(np.isfinite(res.f), res.f, np.inf)
                cap["acq"] = float(f[int(np.argmin(f))])
            return res
        self.patch(loop, "propose_next", lambda _: propose)
        self.patch(lbfgs, "lbfgs_box_multistart", lambda _: solver)

    def step(self, run, n, bo_seed):
        from gpgradpy_torch.bo import loop
        x, f, g = self.problem.data(run, n)
        d = self.problem.dim
        n_init = min(int(self.traffic["n_init"]), n - 1)
        n_iter = n - n_init + 1
        total = n_init + n_iter
        xa = np.full((total, d), np.nan)
        fa = np.full(total, np.nan)
        xa[:n], fa[:n] = x, f
        opt = np.full(total, np.nan)
        opt[:n] = np.linalg.norm(g, axis=1)
        resume = loop.BoTrace(x_all=xa, merit_all=fa, opt_all=opt,
                              fsb_all=np.ones(total),
                              time_iter=np.full(total, np.nan))
        self._capture.clear()
        loop.run_bo(self.problem.objective, self.problem.lb, self.problem.ub,
                    n_iter, n_init=n_init,
                    kernel_type=self.config["kernel_type"],
                    wellcond_mtd=self.config["wellcond_mtd"], acq="ei",
                    exploit_frac=0.0, seed=bo_seed,
                    gp_options=self.gp_options(), resume_trace=resume)
        self.sync()
        gp = self._capture["gp"]
        ans = common.fit_answer(gp, n - n_init)
        return {"run": run, "n": n, "fit": ans, "x_new": self._capture["x"],
                "acq": self._capture["acq"], "fbest": self._capture["fbest"]}

    def request(self, k):
        self.steps.append(self.step(*self.request_args(k)))

    def install_spans(self, rec):
        from gpgradpy_torch import GaussianProcess
        from gpgradpy_torch.bo import loop
        self.patch(GaussianProcess, "set_hpara",
                   self.timed_span(rec, "refit"))
        self.patch(loop, "propose_next", self.timed_span(rec, "propose"))

    def remove_spans(self):
        # the spans were patched over the capture: take off only the spans
        for _ in range(2):
            owner, name, orig = self._patches.pop()
            setattr(owner, name, orig)

    def check(self):
        self.unpatch()
        worst = {}
        cond_max = float(self.config["facade"].get("cond_max_target", 1e10))
        for st in self.steps:
            x, f, g = self.problem.data(st["run"], st["n"])
            vals = common.judge_fit(self, x, f, g, st["fit"],
                                    self.config["wellcond_mtd"])
            m = ref.Model(*(self.ref_tensor(a) for a in (x, f, g)),
                          torch.log10(self.ref_tensor(st["fit"]["theta"])),
                          self.config["wellcond_mtd"], cond_max)
            mu, sig, _, _ = m.predict(self.ref_tensor(st["x_new"][None, :]))
            acq = float(ref.neg_expected_improvement(mu, sig, st["fbest"])[0])
            scale = abs(st["fbest"] - float(mu[0])) + float(sig[0])
            vals["acq_rel"] = abs(st["acq"] - acq) / scale
            common.log_judged(f"run {st['run']} n_eval {st['n']}", vals)
            for k, v in vals.items():
                worst[k] = max(worst.get(k, 0.0), v if np.isfinite(v)
                               else np.inf)
        return self.checks(worst)

    def drop_state(self):
        self._capture.clear()
