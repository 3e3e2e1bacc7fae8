"""What the entries share: the problem's data from the seed, the facade
of gpgradpy_torch built as the configuration states, the capture of a
fit's answers, and their judgement against the plain reference."""

from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

import gpgradpy_torch  # noqa: F401  (a checkout without the program fails here)
from gpbench.reference import gp as ref
from gpbench.reference.rosenbrock import rosenbrock

ROOT = Path(__file__).resolve().parents[2]


def seed_rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of a run's draws (any seed up to 2**64)."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64,
                                                         *stream]))


def cycle_request(traffic: dict, seed: int, k: int):
    """(run, n_eval, seed of the request) of request k.  n_eval cycles over
    the traffic's sizes in a fixed order; cycle c gives size i the run
    perm[(i + c) % R] of a permutation of the R runs drawn from the seed,
    so that every R cycles hold each (run, n_eval) pair once: every seed
    does the same work in another order.  The request's own seed (the
    multistart's, the proposal's) is drawn from the run's seed."""
    sizes, runs = traffic["n_eval"], traffic["runs"]
    perm = seed_rng(seed, 0).permutation(runs)
    i, c = k % len(sizes), k // len(sizes)
    request_seed = int(seed_rng(seed, 1, k).integers(1, 2 ** 31))
    return int(perm[(i + c) % len(runs)]), int(sizes[i]), request_seed


class Problem:
    """The configuration's problem: the recorded runs' points, with f and
    grad f recomputed by the reference's Rosenbrock."""

    def __init__(self, config: dict):
        p = config["problem"]
        self.dim = int(p["dim"])
        self.a = float(p["a"])
        self.lb = np.full(self.dim, float(p["box"][0]))
        self.ub = np.full(self.dim, float(p["box"][1]))
        with np.load(ROOT / config["data"]) as z:
            self.runs = [np.asarray(z[f"run{i}"], np.float64)
                         for i in range(len(z.files))]

    def objective(self, x):
        return rosenbrock(x, self.a)

    def data(self, run: int, n: int):
        x = self.runs[run][:n]
        if x.shape[0] < n:
            raise ValueError(f"run {run} holds {x.shape[0]} points, not {n}")
        f, g = self.objective(x)
        return x, f, g


class Base:
    """The parts of an entry that do not depend on its traffic."""

    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", precision=None):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.on_cuda = self.device.type == "cuda"
        self.precision = precision or config["precision"]
        self.problem = Problem(config)
        self.limits = traffic["limits"]
        self._patches = []

    # -- the program ------------------------------------------------------

    def gp_options(self) -> dict:
        return dict(self.config["facade"], device=str(self.device),
                    dtype=self.precision)

    def new_gp(self):
        from gpgradpy_torch import GaussianProcess
        opts = self.gp_options()
        return GaussianProcess(self.problem.dim, True,
                               self.config["kernel_type"],
                               self.config["wellcond_mtd"], **opts)

    def fit(self, x, f, g, fit_seed: int):
        """One hyperparameter-training round through the facade: a new
        GaussianProcess, set_data, set_hpara('optz', 0)."""
        gp = self.new_gp()
        gp.init_optz_surr(1)
        gp._fit_seed = int(fit_seed)
        n = x.shape[0]
        gp.set_data(x, f, np.zeros(n), g, np.zeros_like(g))
        gp.set_hpara("optz", 0)
        return gp

    def warm(self, fn, *args):
        """One warm-up request; a failure is logged and the run goes on
        (its requests in the window fail the same way and are counted)."""
        try:
            fn(*args)
        except Exception as exc:  # noqa: BLE001 - reported, then measured
            print(f"[gpbench] warm-up failed: {type(exc).__name__}: {exc}",
                  file=sys.stderr)

    def sync(self):
        if self.on_cuda:
            torch.cuda.synchronize(self.device)

    def memory_peak_bytes(self) -> int:
        if self.on_cuda:
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0

    def release(self):
        """Free the program's state before the reference runs."""
        import gc
        self.drop_state()
        gc.collect()
        if self.on_cuda:
            torch.cuda.empty_cache()

    def drop_state(self):
        pass

    def patch(self, owner, name, wrapper):
        """Replace owner.name by wrapper(original) until unpatch()."""
        orig = getattr(owner, name)
        self._patches.append((owner, name, orig))
        setattr(owner, name, wrapper(orig))

    def unpatch(self):
        while self._patches:
            owner, name, orig = self._patches.pop()
            setattr(owner, name, orig)

    def timed_span(self, rec, name):
        """Wrapper factory: a harness span (sync on each side) and a
        profiler range around each call."""
        def wrap(fn):
            def run(*a, **kw):
                self.sync()
                t0 = time.perf_counter()
                with torch.profiler.record_function("gpbench." + name):
                    out = fn(*a, **kw)
                    self.sync()
                rec.span(name, time.perf_counter() - t0)
                return out
            return run
        return wrap

    def install_spans(self, rec):
        pass

    def remove_spans(self):
        self.unpatch()

    # -- judging ------------------------------------------------------------

    def ref_tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64,
                               device=self.device)

    def checks(self, values: dict) -> dict:
        """{name: {value, limit}}; a NaN reading fails its limit."""
        out = {}
        for name, v in values.items():
            v = float(v)
            out[name] = {"value": v if math.isfinite(v) else float("inf"),
                         "limit": float(self.limits[name])}
        return out


def log_judged(what, vals, infos=()):
    """One stderr line per judged answer, with the optimizer's telemetry."""
    tele = [{k: v for k, v in i.items() if k.startswith(("hp_optz_iter_mean",
                                                           "hp_optz_success",
                                                           "optz_n_val"))}
            for i in infos]
    print(f"[gpbench] judged {what}: "
          + ", ".join(f"{k} {v:.3e}" for k, v in vals.items())
          + (f" {tele}" if tele else ""), file=sys.stderr)


def fit_answer(gp, i_optz: int = 0) -> dict:
    """The answers of a fit that the reference judges: theta, the
    closed-form beta and varK, and the -ln L the optimizer reported (of
    training round i_optz)."""
    hp = gp.hp_vals
    return {"theta": np.asarray(hp.theta.detach().cpu(), np.float64),
            "beta": float(hp.beta.detach().cpu().reshape(-1)[0]),
            "varK": float(hp.varK.detach().cpu()),
            "nll": -float(gp.history.ln_lkd[i_optz])}


def theta_box(config: dict):
    """The optimizer's box on log10 theta in a first fit (the facade's
    defaults: theta_init times and over box_factor)."""
    lo, hi = config["theta_box_log10"]
    return float(lo), float(hi)


def judge_fit(entry: Base, x, f, g, ans: dict, method: str,
              xvec_scale=None) -> dict:
    """The reference at the program's answer: -ln L against the reported
    one (nll_rel), the closed-form varK and beta (closed_rel), and the
    projected gradient of -ln L in log10 theta, over max(1, |-ln L|)
    (stationarity)."""
    cond_max = float(entry.config["facade"].get("cond_max_target", 1e10))
    X, F, G = (entry.ref_tensor(a) for a in (x, f, g))
    if xvec_scale is not None:
        X, F, G = ref.rescaled_frame(X, F, G, entry.ref_tensor(xvec_scale))
    lt = torch.log10(entry.ref_tensor(ans["theta"]))
    nll, grad, m = ref.nll_and_grad(X, F, G, lt, method, cond_max)
    nll = float(nll)
    lo, hi = theta_box(entry.config)
    pg = ref.projected_grad(grad, lt, lo, hi)
    varK = float(m.varK.detach())
    return {
        "nll_rel": abs(ans["nll"] - nll) / abs(nll),
        "closed_rel": max(abs(ans["varK"] - varK) / varK,
                          abs(ans["beta"] - float(m.beta[0].detach()))
                          / math.sqrt(varK)),
        "stationarity": float(pg.abs().max()) / max(1.0, abs(nll)),
    }
