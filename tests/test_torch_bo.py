"""The port's Bayesian-optimization loop against the JAX package, in float64
on the CPU (d <= 2): the acquisition functions, the batched acquisition
objective and propose_next at an equal GP state, the local trust-region
exploit, run_bo (initial design, first proposal, checkpoints, resume,
duplicate guard, noise), multistart and constrained BO, the trace reader,
and the facade's calc_model_mean_w_data_*.

The equal GP state is a JAX fit whose hyperparameters are carried over
through gpgradpy_torch.convert, at cond_max_target 1e6 in both packages: at
the default 1e10 the two LAPACKs' solves set the posterior mean ~1e-10 and
the std ~1e-9 of their largest entries apart (test_torch_fit_predict.py::
test_eval_model_matches_jax), and EI = (f* - mu) Phi + sig phi carries the
mean's error scaled by |mu| / max EI (~4000 on this Rosenbrock problem).
The JAX runs are shared through module-scoped fixtures.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_tpu.bo import acquisition as jacq
from gpgradpy_tpu.bo import loop as jloop
from gpgradpy_tpu.model import predict as jpred
from gpgradpy_tpu.results import PltOptzResults as JaxResults
from gpgradpy_tpu.types import Hypers as JaxHypers
from gpgradpy_torch import GaussianProcess, convert
from gpgradpy_torch.bo import acquisition, loop, problems
from gpgradpy_torch.results import PltOptzResults

CPU = {"device": "cpu"}
LB, UB = np.full(2, -2.0), np.full(2, 2.0)
ACQS = ["ei", "ucb", "mu"]


def _data(n=12, d=2, seed=0):
    x = np.random.default_rng(seed).uniform(-2, 2, (n, d))
    f, g = problems.rosenbrock(x)
    return x, f, g


def _carry(gp_j, gp_t, method="set"):
    """Give the port's GP the JAX GP's hyperparameters (and set it up)."""
    hp = {k: None if v is None else np.asarray(v)
          for k, v in gp_j.hp_vals._asdict().items()}
    gp_t.set_hpara(method, 0,
                   hp_vals=convert.hypers_from_numpy(hp, device="cpu"))
    return gp_t


def _gp_pair(cls_kw=None, x=None, f=None, g=None, fit=True,
             wellcond="precon", theta=None):
    """A JAX GP (fitted, or set at ``theta``) and the port's GP on the same
    data with the same hyperparameters."""
    kw = {"cond_max_target": 1e6, **(cls_kw or {})}
    n, d = x.shape
    gps = []
    for cls, extra in ((JaxGP, {}), (GaussianProcess, CPU)):
        gp = cls(d, True, "SqExp", wellcond, **kw, **extra)
        gp.init_optz_surr(2)
        gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
        gps.append(gp)
    gj, gt = gps
    if fit:
        gj.set_hpara("optz", 0)
    else:
        gj.set_hpara("set", 0, hp_vals=JaxHypers(theta=jnp.asarray(theta)))
    return gj, _carry(gj, gt)


@pytest.fixture(scope="module")
def equal_state():
    x, f, g = _data()
    gj, gt = _gp_pair(x=x, f=f, g=g)
    return gj, gt, float(f.min())


def _jax_acq(gj, acq, fb, X):
    """JAX's acq_and_grad (loop.py:43-55 there) at each row of X."""
    def row(x):
        mu, sig, dmu, dsig, _, _ = jpred.eval_model(
            gj.cfg, gj.spec, gj.data, gj._eval_state, x[None, :],
            calc_grad=True)
        if acq == "ucb":
            a, da = jacq.ucb(mu, sig, dmu, dsig, beta=2.0)
        elif acq == "mu":
            a, da = mu, dmu
        else:
            a, da = jacq.expected_improvement(mu, sig, fb, dmu, dsig)
        return a[0], da[0]
    return map(np.asarray, jax.vmap(row)(jnp.asarray(X)))


def _close_to_largest(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=rtol * np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# acquisition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("acq", ["ucb", "ei"])
def test_acquisition_matches_jax(acq):
    """Values and x-gradients from the same (mu, sig, dmu, dsig) at rtol
    1e-12, a std below sig_min among them."""
    rng = np.random.default_rng(1)
    mu, sig = rng.normal(0.0, 1.0, 6), rng.uniform(0.01, 1.0, 6)
    sig[2] = 1e-14
    dmu, dsig = rng.normal(0.0, 1.0, (6, 3)), rng.normal(0.0, 0.3, (6, 3))
    if acq == "ucb":
        want = jacq.ucb(*map(jnp.asarray, (mu, sig, dmu, dsig)), beta=2.0)
        got = acquisition.ucb(*map(torch.as_tensor, (mu, sig, dmu, dsig)),
                              beta=2.0)
    else:
        want = jacq.expected_improvement(jnp.asarray(mu), jnp.asarray(sig),
                                         0.1, jnp.asarray(dmu),
                                         jnp.asarray(dsig))
        got = acquisition.expected_improvement(
            torch.as_tensor(mu), torch.as_tensor(sig), 0.1,
            torch.as_tensor(dmu), torch.as_tensor(dsig))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-300)
    assert acquisition.ucb(torch.as_tensor(mu), torch.as_tensor(sig))[1] \
        is None


def test_acquisition_gradients():
    """The JAX test's finite-difference check (tests/test_bo.py:29-50) on
    the port's functions."""
    mu = torch.tensor([0.5, -0.2], dtype=torch.float64)
    sig = torch.tensor([0.3, 0.8], dtype=torch.float64)
    dmu = torch.tensor([[0.1, 0.2], [0.3, -0.1]], dtype=torch.float64)
    dsig = torch.tensor([[0.05, -0.02], [0.02, 0.04]], dtype=torch.float64)
    a, da = acquisition.ucb(mu, sig, dmu, dsig, beta=2.0)
    np.testing.assert_allclose(a, mu - 2 * sig)
    np.testing.assert_allclose(da, dmu - 2 * dsig)

    ei = acquisition.expected_improvement
    _, da = ei(mu, sig, 0.1, dmu, dsig)
    eps = 1e-6
    e = torch.eye(2, dtype=torch.float64) * eps
    for i in range(2):
        dadmu = (ei(mu + e[i], sig, 0.1)[0][i]
                 - ei(mu - e[i], sig, 0.1)[0][i]) / (2 * eps)
        dadsig = (ei(mu, sig + e[i], 0.1)[0][i]
                  - ei(mu, sig - e[i], 0.1)[0][i]) / (2 * eps)
        want = dadmu * dmu[i] + dadsig * dsig[i]
        np.testing.assert_allclose(da[i], want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("acq", ACQS)
def test_acq_objective_matches_jax(equal_state, acq):
    """The batched objective at propose_next's 17 starts (16 LHS points
    and the best data point) in one call, against JAX's acq_and_grad row
    by row: values and gradients at rtol 1e-9 of their largest entry."""
    gj, gt, fb = equal_state
    X = loop.acq_starts(gt, LB, UB, 16, seed=3)
    assert X.shape == (17, 2)
    a_t, g_t, aux = loop.acq_objective(gt, acq, 2.0, fb)(X)
    a_j, g_j = _jax_acq(gj, acq, fb, X)
    _close_to_largest(a_t, a_j, 1e-9)
    _close_to_largest(g_t, g_j, 1e-9)
    assert np.all(aux == 0.0)


@pytest.mark.parametrize("acq", ACQS)
def test_propose_next_matches_jax(equal_state, acq):
    """Proposals within 1e-5 of JAX's (both optimizers stop where the line
    search meets round-off, 1e-8 to 6e-7 apart here; 'mu' after the Newton
    polish), and the acquisition at each package's proposal at rtol 1e-8."""
    gj, gt, fb = equal_state
    x_j = jloop.propose_next(gj, LB, UB, fb, acq=acq, seed=3)
    x_t = loop.propose_next(gt, LB, UB, fb, acq=acq, seed=3)
    np.testing.assert_allclose(x_t, x_j, rtol=0.0, atol=1e-5)
    a_t = loop.acq_objective(gt, acq, 2.0, fb)(x_t[None, :])[0]
    a_j = next(_jax_acq(gj, acq, fb, x_j[None, :]))
    np.testing.assert_allclose(a_t, a_j, rtol=1e-8)
    assert np.all((LB <= x_t) & (x_t <= UB))


# ---------------------------------------------------------------------------
# the local trust-region exploit
# ---------------------------------------------------------------------------

def _cluster(bowl):
    rng = np.random.default_rng(1)
    if not bowl:
        x = 1.0 + 0.3 * rng.standard_normal((10, 2))
        return (x, *problems.rosenbrock(x))
    # a bowl whose minimizer lies 1e-4 from the incumbent c, the four
    # points nearest c symmetric about it
    c = np.array([0.5, -0.2])
    x = np.vstack([c, c + 0.3 * np.array([[1, 0], [-1, 0], [0, 1], [0, -1]]),
                   c + rng.uniform(0.6, 1.0, (5, 2))])
    return x, np.sum((x - c - 1e-4) ** 2, 1), 2 * (x - c - 1e-4)


@pytest.mark.parametrize("case", ["fresh", "kept", "clipped", "moved",
                                  "grad_step"])
def test_local_exploit_matches_jax(case, monkeypatch):
    """_propose_local_exploit in both packages from the same state: the
    radius anchored at min(r_loc, 0.05 diam) (fresh, or an incumbent that
    moved), kept (1.0), or clipped to 0.25 diam (10.0), then damped Newton
    on the local GP.  With the radius floor raised to 1e-3 of the diameter
    in both packages, Newton's step to a bowl's minimizer 1.4e-4 away falls
    below it and the gradient-step branch steps delta / 2 down the
    incumbent's gradient.  The proposal to 1e-8 (the local fits' optima
    agree to ~1e-9 here), the radius and r_loc to 1e-12, the branch
    equal."""
    x, f, g = _cluster(case == "grad_step")
    x_inc = x[np.argmin(f)]
    if case == "grad_step":
        for mod in (jloop, loop):
            monkeypatch.setattr(mod, "_TR_FLOOR_REL", 1e-3)
    state0 = {"kept": {"x_inc": x_inc.copy(), "delta": 1.0},
              "clipped": {"x_inc": x_inc.copy(), "delta": 10.0},
              "moved": {"x_inc": x_inc + 0.1, "delta": 1.0}}.get(case, {})
    out = {}
    for name, mod, opts in (("j", jloop, {}), ("t", loop, CPU)):
        state, dbg = dict(state0), {}
        x_new = mod._propose_local_exploit(
            x, f, g, LB, UB, "SqExp", n_local=5, dtype="float64",
            state=state, debug=dbg, gp_opts=opts)
        out[name] = x_new, state, dbg
    (xj, sj, dj), (xt, st, dt) = out["j"], out["t"]
    np.testing.assert_allclose(xt, xj, rtol=0.0, atol=1e-8)
    np.testing.assert_allclose(st["delta"], sj["delta"], rtol=1e-12)
    np.testing.assert_allclose(dt["r_loc"], dj["r_loc"], rtol=1e-12)
    assert dt["branch"] == dj["branch"]
    diam = np.linalg.norm(UB - LB)
    want_delta = {"kept": 1.0, "clipped": 0.25 * diam}.get(
        case, min(dj["r_loc"], 0.05 * diam))
    np.testing.assert_allclose(st["delta"], want_delta, rtol=1e-15)
    if case == "grad_step":
        assert dt["branch"] == "grad_step"
        want = x_inc + 0.5 * want_delta * np.ones(2) / np.sqrt(2.0)
        np.testing.assert_allclose(xt, want, rtol=1e-14)
    else:
        assert dt["branch"] == "newton" and dt["n_accept"] >= 1
    assert st["hp_local"].theta.device.type == "cpu"


def _verbose_run(mod, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trace = mod.run_bo(*a, verbose=True, **kw)
    return trace, buf.getvalue().splitlines()


def test_run_bo_exploit_phase_matches_jax():
    """Six exploit-only iterations (exploit_frac 1, exploit_local): local
    fits, Newton, and the trust-region radius expanded on improvement of
    the truth and shrunk on failure (the last step fails) follow the JAX
    run: points to 1e-6, merits to rtol 1e-5, each step's branch and r_loc
    to 3 digits (the count of accepted Newton steps past convergence rests
    on round-off)."""
    kw = dict(n_iter=6, n_init=6, exploit_frac=1.0, exploit_local=True,
              seed=2)
    tj, lj = _verbose_run(jloop, problems.rosenbrock, LB, UB,
                          gp_options={"pad_n_eval_multiple": 8}, **kw)
    tt, lt = _verbose_run(loop, problems.rosenbrock, LB, UB,
                          gp_options=dict(CPU, pad_n_eval_multiple=8), **kw)
    np.testing.assert_allclose(tt.x_all, tj.x_all, rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(tt.merit_all, tj.merit_all, rtol=1e-5)
    assert len(lt) == len(lj) == 6

    def strip(line):
        return line.split(" acc=")[0]
    assert [strip(s) for s in lt] == [strip(s) for s in lj]
    assert all("exploit[newton]" in s for s in lt)
    assert tt.merit_all[-1] > np.min(tt.merit_all[:-1])   # a failed step


# ---------------------------------------------------------------------------
# run_bo
# ---------------------------------------------------------------------------

BO_KW = dict(n_init=6, seed=2)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX run of 3 iterations with a checkpoint after each."""
    ckpts = []
    trace = jloop.run_bo(problems.rosenbrock, LB, UB, 3,
                         gp_options={"pad_n_eval_multiple": 8},
                         checkpoint_cb=ckpts.append, checkpoint_every=1,
                         **BO_KW)
    return trace, ckpts


def test_run_bo_matches_jax(jax_run):
    """The initial design bitwise equal to JAX's, the first proposal within
    1e-5, and the checkpoint cadence: every checkpoint_every iterations a
    trace whose un-run iterations are NaN."""
    tj, _ = jax_run
    ckpts = []
    tt = loop.run_bo(problems.rosenbrock, LB, UB, 3,
                     gp_options=dict(CPU, pad_n_eval_multiple=8),
                     checkpoint_cb=ckpts.append, checkpoint_every=2, **BO_KW)
    n0 = BO_KW["n_init"]
    for k in ("x_all", "merit_all", "opt_all", "fsb_all"):
        np.testing.assert_array_equal(getattr(tt, k)[:n0],
                                      getattr(tj, k)[:n0])
    np.testing.assert_allclose(tt.x_all[n0], tj.x_all[n0], rtol=0.0,
                               atol=1e-5)
    assert np.all(np.isfinite(tt.merit_all)) and np.all(tt.time_iter[n0:] > 0)
    assert np.all(np.isnan(tt.time_iter[:n0]))
    assert len(ckpts) == 1                  # after iteration 1 of 0..2
    assert np.isfinite(ckpts[0].merit_all[:n0 + 2]).all()
    assert np.isnan(ckpts[0].merit_all[n0 + 2:]).all()


def test_run_bo_resumes_a_jax_trace(jax_run):
    """A JAX checkpoint after 2 of 3 iterations resumes in the port: the
    recorded prefix is re-evaluated once, kept bitwise, and only the last
    iteration runs."""
    tj, ckpts = jax_run
    partial = ckpts[1]
    n_done = BO_KW["n_init"] + 2
    assert np.isfinite(partial.merit_all).sum() == n_done
    calls = []

    def obj(x):
        calls.append(len(x))
        return problems.rosenbrock(x)
    tt = loop.run_bo(obj, LB, UB, 3, gp_options=dict(CPU, pad_n_eval_multiple=8),
                     resume_trace=partial, **BO_KW)
    assert calls == [BO_KW["n_init"], n_done, 1]
    for k in loop.BoTrace._fields:
        np.testing.assert_array_equal(getattr(tt, k)[:n_done],
                                      getattr(partial, k)[:n_done])
    assert np.isfinite(tt.merit_all).all()


def test_run_bo_resume_errors(jax_run):
    _, ckpts = jax_run
    partial = ckpts[1]
    args = (LB, UB, 3)
    kw = dict(gp_options=CPU, **BO_KW)
    with pytest.raises(ValueError, match="noise-free"):
        loop.run_bo(problems.rosenbrock, *args, noise_std=0.1,
                    resume_trace=partial, **kw)
    gap = partial._replace(merit_all=partial.merit_all.copy())
    gap.merit_all[3] = np.nan
    with pytest.raises(ValueError, match="not contiguous"):
        loop.run_bo(problems.rosenbrock, *args, resume_trace=gap, **kw)
    with pytest.raises(ValueError, match="do not match obj_fun"):
        loop.run_bo(lambda x: problems.rosenbrock(x, a=5.0), *args,
                    resume_trace=partial, **kw)


def test_run_bo_duplicate_guard(monkeypatch):
    """A proposal on an existing datum: in the explore phase propose_next
    runs again with seed + 7919 (i + 1); in the exploit phase the radius
    shrinks by 4 and a ball sample of radius delta / 2 around the
    incumbent is evaluated instead, and at the radius floor the run stops
    with a NaN tail."""
    seeds = []
    real = loop.propose_next

    def dup_first(gp, lb, ub, fb, seed=0, **kw):
        seeds.append(seed)
        if len(seeds) == 1:
            return gp.data.x[0].numpy().copy()
        return real(gp, lb, ub, fb, seed=seed, **kw)
    monkeypatch.setattr(loop, "propose_next", dup_first)
    tr = loop.run_bo(problems.rosenbrock, LB, UB, 1, gp_options=CPU, **BO_KW)
    assert seeds == [2, 2 + 7919]
    assert np.min(np.linalg.norm(tr.x_all[:-1] - tr.x_all[-1], axis=1)) > 0

    states = []

    def incumbent(x_data, f_data, g_data, lb, ub, *a, state, **kw):
        x_inc = x_data[np.argmin(f_data)]
        state.setdefault("delta", 0.2)
        state["x_inc"] = x_inc.copy()
        states.append(state["delta"])
        return x_inc.copy()
    monkeypatch.setattr(loop, "_propose_local_exploit", incumbent)
    kw = dict(exploit_frac=1.0, exploit_local=True, gp_options=CPU, **BO_KW)
    tr = loop.run_bo(problems.rosenbrock, LB, UB, 1, **kw)
    x_inc = tr.x_all[np.argmin(tr.merit_all[:6])]
    np.testing.assert_allclose(np.linalg.norm(tr.x_all[6] - x_inc), 0.1,
                               rtol=1e-12)
    diam = np.linalg.norm(UB - LB)
    states.clear()
    monkeypatch.setattr(loop, "_TR_FLOOR_REL", 0.2 / diam)
    tr = loop.run_bo(problems.rosenbrock, LB, UB, 2, **kw)
    assert len(states) == 1 and np.isnan(tr.merit_all[6:]).all()


def test_run_bo_noise():
    """With noise_std the initial design's values and gradients carry the
    seeded noise bitwise as in JAX, and the exploit phase falls back to
    the posterior mean (the local exploit needs noise-free data)."""
    kw = dict(noise_std=0.1, **BO_KW)
    tj = jloop.run_bo(problems.rosenbrock, LB, UB, 0, **kw)
    tt = loop.run_bo(problems.rosenbrock, LB, UB, 0, gp_options=CPU, **kw)
    for k in ("x_all", "merit_all", "opt_all"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(tj, k))
    clean = problems.rosenbrock(tt.x_all)[0]
    assert np.all(tt.merit_all != clean)
    fired = []
    real = loop._propose_local_exploit
    loop_kw = dict(exploit_frac=0.5, exploit_local=True, gp_options=CPU, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "_propose_local_exploit",
                   lambda *a, **k: fired.append(1) or real(*a, **k))
        tr, lines = _verbose_run(loop, problems.rosenbrock, LB, UB, 2,
                                 **loop_kw)
    assert fired == [] and len(lines) == 2
    assert np.isfinite(tr.merit_all).all()


def test_bo_gps_live_on_the_asked_device(monkeypatch):
    """Every GP of a run, the local exploit GPs included, lies on the CPU
    when asked."""
    made = []

    class Spy(GaussianProcess):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(loop, "GaussianProcess", Spy)
    loop.run_bo(problems.rosenbrock, LB, UB, 2, exploit_frac=0.5,
                exploit_local=True, gp_options=CPU, **BO_KW)
    assert len(made) == 2                    # the global GP, one local GP
    assert all(gp.device.type == "cpu" and gp.data.x.device.type == "cpu"
               for gp in made)


def test_bo_entry_points_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: loop.run_bo(problems.sin_1d, [2.5], [7.5], 1),
                 lambda: loop.run_bo_multistart(problems.sin_1d, [2.5],
                                                [7.5], 1, n_x0=1),
                 lambda: loop.run_bo_constrained(problems.sin_1d, [],
                                                 [2.5], [7.5], 1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------------------------------------
# multistart, constrained BO, the trace reader
# ---------------------------------------------------------------------------

def test_bo_trace_schema(tmp_path):
    """The npz of run_bo_multistart (tests/test_bo.py:64-77) loads through
    both packages' PltOptzResults, with the same arrays."""
    path = tmp_path / "trace.npz"
    out = loop.run_bo_multistart(problems.sin_1d, [2.5], [7.5], n_iter=3,
                                 n_x0=2, n_init=3, save_path=str(path),
                                 gp_options=CPU)
    data = np.load(path)
    for key in ("x0_all", "merit_all", "opt_all", "fsb_all",
                "merit_wo_noise_all", "opt_wo_noise_all", "fsb_wo_noise_all"):
        assert key in data
        np.testing.assert_array_equal(data[key], out[key])
    assert data["merit_all"].shape == (2, 6)
    assert data["x0_all"].shape == (2, 6, 1)
    assert np.all(np.isfinite(data["merit_all"]))
    got = PltOptzResults.load_npz_data(str(tmp_path), ["trace.npz"],
                                       n_iter_max=None)
    want = JaxResults.load_npz_data(str(tmp_path), ["trace.npz"],
                                    n_iter_max=None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (1, 2, 6)


def test_plt_optz_results_reads_the_d10_corpus(tmp_path):
    """The port's reader on results_data/full_d10's merged traces, against
    the JAX package's: loaded arrays, best-so-far, summaries, the plot."""
    folder = "results_data/full_d10"
    files = [f"Rosen_a10_d10_{m}_all.npz" for m in
             ("Precondition", "Baseline", "Rescaling")]
    got = PltOptzResults.load_npz_data(folder, files, n_iter_max=None)
    want = JaxResults.load_npz_data(folder, files, n_iter_max=None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[0] == 3 and got[0].shape[2] == 202
    for a, b in zip(PltOptzResults.summarize(got[0], got[1]),
                    JaxResults.summarize(want[0], want[1])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        PltOptzResults.best_at_all_iter(got[0][0, 0]),
        JaxResults.best_at_all_iter(want[0][0, 0]))
    png = tmp_path / "conv.png"
    PltOptzResults.plt_conv_nx0(got[0], ["P", "B", "R"], str(png))
    assert png.stat().st_size > 0


def _con(x):
    x = np.atleast_2d(x)
    c = 0.5 - x[:, 0]
    g = np.zeros_like(x)
    g[:, 0] = -1.0
    return c, g


def _sq(x):
    x = np.atleast_2d(x)
    return np.sum(x ** 2, 1), 2 * x


def test_constrained_score_matches_jax():
    """EI x P(c <= 0) at 65 candidates against the JAX loop's inline score
    (loop.py:567-577 there), objective and constraint GPs at the JAX fits'
    hyperparameters: rtol 1e-9 of the largest score.  Then two iterations
    of the port's run_bo_constrained on the CPU."""
    from jax.scipy.stats import norm as jnorm
    x = np.random.default_rng(4).uniform(-1, 1, (8, 2))
    pairs = [_gp_pair(x=x, f=fn(x)[0], g=fn(x)[1]) for fn in (_sq, _con)]
    cand = np.random.default_rng(5).uniform(-1, 1, (65, 2))
    fbest = 0.6
    mu, sig = pairs[0][0].eval_model(cand)[:2]
    want = -np.asarray(jacq.expected_improvement(jnp.asarray(mu),
                                                 jnp.asarray(sig), fbest)[0])
    muc, sigc = pairs[1][0].eval_model(cand)[:2]
    want = want * np.asarray(jnorm.cdf(
        (0.0 - jnp.asarray(muc)) / jnp.maximum(jnp.asarray(sigc), 1e-12)))
    got = loop.constrained_score(pairs[0][1], [pairs[1][1]], cand, fbest)
    assert np.max(want) > 0.05
    _close_to_largest(got, want, 1e-9)
    assert np.argmax(got) == np.argmax(want)

    tr = loop.run_bo_constrained(_sq, [_con], [-1, -1], [1, 1], n_iter=2,
                                 n_init=6, gp_options=CPU)
    assert np.isfinite(tr.merit_all).all() and tr.fsb_all.shape == (8,)
    assert set(np.unique(tr.fsb_all)) <= {0.0, 1.0}


# ---------------------------------------------------------------------------
# the facade's mean with another data vector
# ---------------------------------------------------------------------------

def _sin_data():
    n = 8
    x = np.linspace(2.5, 7.5, n)[:, None]
    f = np.sin(x[:, 0]) + np.sin(10 * x[:, 0] / 3)
    g = (np.cos(x[:, 0]) + (10 / 3) * np.cos(10 * x[:, 0] / 3))[:, None]
    return x, f, g


def test_calc_model_mean_w_data_matches_jax():
    """tests/test_api_extras.py:34-48 at equal hyperparameters (the JAX
    fit's, default cond_max_target): with the original data it gives
    eval_model's mean; with other data it matches the JAX outputs (rtol
    1e-8, floor 1e-10 of the largest entry, the eval_model parity of
    test_torch_fit_predict); without a frame _scl equals _init."""
    x, f, g = _sin_data()
    gj, gt = _gp_pair({"cond_max_target": 1e10}, x, f, g)
    xq = np.array([[4.2], [6.0]])
    mu_ref, _, dmu_ref, *_ = gt.eval_model(xq, calc_grad=True)
    mu, dmu = gt.calc_model_mean_w_data_init(xq, f, g, calc_grad=True)
    np.testing.assert_allclose(mu, mu_ref, rtol=1e-8)
    np.testing.assert_allclose(dmu, dmu_ref, rtol=1e-8)
    for data in ((f, g), (2 * f, 2 * g)):
        got = gt.calc_model_mean_w_data_init(xq, *data, calc_grad=True)
        want = gj.calc_model_mean_w_data_init(xq, *data, calc_grad=True)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-8,
                                       atol=1e-10 * np.max(np.abs(b)))
    mu2, dmu2 = gt.calc_model_mean_w_data_init(xq, 2 * f, 2 * g,
                                               calc_grad=False)
    assert dmu2 is None and not np.allclose(mu2, mu)
    mu3, dmu3 = gt.calc_model_mean_w_data_scl(xq, f, g, calc_grad=True)
    np.testing.assert_allclose(mu3, mu, rtol=1e-12)
    np.testing.assert_allclose(dmu3, dmu, rtol=1e-12)


def test_calc_model_mean_w_data_rescaled_frame():
    """tests/test_api_extras.py:51-75 with 'rescale_origin' at a set theta
    (both packages keep the frame that set_data builds): _init and _scl
    against the JAX outputs (rtol 1e-9), and _init == frame transform +
    _scl (rtol 1e-10)."""
    rng = np.random.default_rng(3)
    n, d = 12, 2
    x = rng.uniform(-2, 2, (n, d))
    f = np.sum(x ** 2, 1) + 1.5
    g = 2 * x
    gj, gt = _gp_pair(x=x, f=f, g=g, fit=False, wellcond="rescale_origin",
                      theta=np.array([0.7, 1.3]))
    np.testing.assert_array_equal(gt.DataScl.xvec_scale, gj.DataScl.xvec_scale)
    xq = rng.uniform(-1.5, 1.5, (3, d))
    f2 = f + 0.3 * np.sin(x[:, 0])
    g2 = g.copy()
    g2[:, 0] += 0.3 * np.cos(x[:, 0])
    got = gt.calc_model_mean_w_data_init(xq, f2, g2, calc_grad=True)
    want = gj.calc_model_mean_w_data_init(xq, f2, g2, calc_grad=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    s = gt.DataScl
    xq_s = s.x_init_2_scl(xq)
    f2_s, _, g2_s, _ = s.obj_init_2_scl(f2, None, g2, None)[:4]
    got_s = gt.calc_model_mean_w_data_scl(xq_s, f2_s, g2_s, calc_grad=True)
    want_s = gj.calc_model_mean_w_data_scl(xq_s, f2_s, g2_s, calc_grad=True)
    for a, b, c in zip(got_s, got, want_s):
        np.testing.assert_allclose(a, b, rtol=1e-10)
        np.testing.assert_allclose(a, c, rtol=1e-9)


# ---------------------------------------------------------------------------
# the JAX package's slow BO tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_bo_sin1d_converges():
    """10 BO iterations on sin(x)+sin(10x/3) over [2.5, 7.5] must locate the
    global minimum region (x* ~ 5.146, f* ~ -1.90)."""
    trace = loop.run_bo(problems.sin_1d, [2.5], [7.5], n_iter=10, n_init=4,
                        acq="ei", seed=0, gp_options=CPU)
    assert np.nanmin(trace.merit_all) < -1.85
    best_x = trace.x_all[np.nanargmin(trace.merit_all), 0]
    assert abs(best_x - 5.1457) < 0.2


@pytest.mark.slow
def test_constrained_bo():
    """Constrained BO: minimize sum(x^2) s.t. x_0 >= 0.5 over [-1, 1]^2;
    optimum at (0.5, 0) with f = 0.25."""
    trace = loop.run_bo_constrained(_sq, [_con], [-1, -1], [1, 1],
                                    n_iter=12, n_init=8, seed=0,
                                    gp_options=CPU)
    feas = trace.fsb_all > 0.5
    assert feas.any()
    best_feas = np.nanmin(trace.merit_all[feas])
    assert best_feas < 0.30, best_feas  # optimum 0.25
