"""Surrogate evaluations, closed loop, one caller.

Set-up fits one model on the first n_fit points of a recorded run (the
seed draws the run): set-up that the traffic needs.  Request k is one
``eval_model(x, calc_grad=True)`` of m points (mu, sig and their
x-gradients, on the host), in the mix that BO explore steps send
(recorded by gpbench/tools/record_predict_mix.py): m drawn from the
recorded count of calls of each number of rows, and each point at a
distance from a datum drawn from the recorded distances to the nearest
datum (their quantiles, interpolated), in a uniform direction from a datum
drawn uniformly, clipped to the box; all drawn from the seed.

Judged after the window: the set-up fit as a fit entry judges one (the
reference takes the program's theta, as it follows the program's state),
and a sample of the requests drawn from the seed, with the largest in it:
mu, sig, dmu/dx and dsig/dx against the reference's at the same theta,
each as its largest gap over the largest reference value of its kind.
"""

from __future__ import annotations

import numpy as np

from gpbench.entries import common
from gpbench.reference import gp as ref


class Entry(common.Base):

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        t = self.traffic
        self.run = int(common.seed_rng(self.seed, 0).choice(t["runs"]))
        self.n_fit = int(t["n_fit"])
        counts = {int(m): float(c) for m, c in t["m_counts"].items()}
        self.m_values = np.array(sorted(counts))
        self.m_p = np.array([counts[m] for m in self.m_values])
        self.m_p /= self.m_p.sum()
        self.dist_q = np.asarray(t["distance_quantiles"], np.float64)
        self.x_fit = self.problem.data(self.run, self.n_fit)[0]
        self.outputs = []
        self.gp = None

    def query(self, k):
        """The points of request k (see the module's note)."""
        rng = common.seed_rng(self.seed, 1, k)
        m = int(rng.choice(self.m_values, p=self.m_p))
        return self.points(rng, m)

    def points(self, rng, m):
        d = self.problem.dim
        anchor = self.x_fit[rng.integers(0, len(self.x_fit), m)]
        u = rng.standard_normal((m, d))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        r = np.interp(rng.uniform(0.0, 1.0, m),
                      np.linspace(0.0, 1.0, len(self.dist_q)), self.dist_q)
        return np.clip(anchor + r[:, None] * u, self.problem.lb,
                       self.problem.ub)

    def setup(self):
        import gpgradpy_torch.ops.cuda_assembly  # noqa: F401  (K1/K2 load)
        x, f, g = self.problem.data(self.run, self.n_fit)
        fit_seed = int(common.seed_rng(self.seed, 2).integers(1, 2 ** 31))
        self.gp = self.fit(x, f, g, fit_seed)
        self.fit_ans = common.fit_answer(self.gp)
        rng = common.seed_rng(self.seed, 3)
        for m in self.m_values:
            self.warm(self.gp.eval_model, self.points(rng, int(m)), True)
        self.sync()

    def request(self, k):
        mu, sig, dmu, dsig = self.gp.eval_model(self.query(k),
                                                calc_grad=True)[:4]
        self.outputs.append((mu, sig, dmu, dsig))

    def drop_state(self):
        self.gp = None

    def check(self):
        x, f, g = self.problem.data(self.run, self.n_fit)
        vals = common.judge_fit(self, x, f, g, self.fit_ans,
                                self.config["wellcond_mtd"])
        n = len(self.outputs)
        if n == 0:
            return self.checks(dict(vals, mu_rel=np.inf, sig_rel=np.inf,
                                    grad_rel=np.inf))
        sizes = np.array([len(o[0]) for o in self.outputs])
        rng = common.seed_rng(self.seed, 4)
        k_sample = min(n, int(self.traffic["check_requests"]))
        pick = set(rng.choice(n, k_sample, replace=False).tolist())
        pick.add(int(np.argmax(sizes)))
        cond_max = float(self.config["facade"].get("cond_max_target", 1e10))
        m = ref.Model(*(self.ref_tensor(a) for a in (x, f, g)),
                      self.ref_tensor(np.log10(self.fit_ans["theta"])),
                      self.config["wellcond_mtd"], cond_max)
        gaps = np.zeros(4)
        tops = np.zeros(4)
        for k in sorted(pick):
            want = m.predict(self.ref_tensor(self.query(k)))
            for i, (got, w) in enumerate(zip(self.outputs[k], want)):
                w = w.detach().cpu().numpy()
                gaps[i] = max(gaps[i], float(np.max(np.abs(got - w))))
                tops[i] = max(tops[i], float(np.max(np.abs(w))))
        rel = gaps / tops
        vals.update(mu_rel=rel[0], sig_rel=rel[1],
                    grad_rel=max(rel[2], rel[3]))
        return self.checks(vals)
