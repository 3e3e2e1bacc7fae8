"""The port's examples (gpgradpy_torch/examples) against the JAX package's
(examples/), CPU, float64.

Each JAX example computes and plots in one ``main``; its numbers are read
where they reach the plot, through a recording stand-in for
``plt.subplots``, and held to the port example's ``compute`` at the
example's own size.  Tolerances:
- kernel curves: rtol 1e-10;
- likelihood and condition-number curves at fixed hyperparameters: the
  log-likelihood to rtol 1e-7 and log10 cond to atol 1e-6.  Both reach
  cond ~1e10, where two LAPACK builds set the quadratic form ~4e-8 and the
  smallest eigenvalue ~1e-6 apart (relative; ROADMAP Queue 3, "Two
  LAPACKs"); the surrogate at such a maximum of the likelihood to 1e-5 of
  its largest entry (measured: 4e-7 for mu, 1.9e-6 for sig at gamma 0.093);
- predictions and EI after a fit: rtol 1e-3 of the largest entry (the two
  optimizers stop on a flat optimum, test_torch_facade);
- the BO worker: the same npz keys, shapes and dtypes, the same initial
  design and its values exactly.
- large_n_demo (world size 1) with the JAX example's probes against the
  JAX example's loop on its 8-device mesh: theta rtol 1e-8, mu rtol 1e-7,
  sig rtol 1e-5 (the iterative tests' tolerances), -ln L rtol 5e-8 (its
  CG's tolerance, 1e-8, sets it);
  scaling_harness at world sizes 1 and 2 (spawned gloo groups): each
  point's best start rtol 1e-8 of the JAX multistart solver's, and the
  sampler equal across the world sizes in its trees, to rtol 1e-7 in its
  mean.

The whole-script runs with ``--device cpu`` carry the ``slow`` mark exactly
where their JAX counterparts in tests/test_examples.py do.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import examples.plt_acq as jax_acq
import examples.plt_cond as jax_cond
import examples.plt_kern_corr as jax_kern_corr
import examples.plt_nugget_1d as jax_nugget
import examples.plt_surr_1d as jax_surr
import examples.run_paper_traces as jax_traces
from gpgradpy_torch.examples import (large_n_demo, optz_paper_precon,
                                     plt_acq, plt_cond, plt_kern_corr,
                                     plt_nugget_1d, plt_surr_1d,
                                     run_paper_traces, scaling_harness)
from gpgradpy_torch.results import PltOptzResults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Axes:
    """Records every call made on it: (method name, args, kwargs)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def record(*args, **kw):
            self.calls.append((name, args, kw))
        return record

    def args_of(self, name):
        return [a for n, a, _ in self.calls if n == name]


@pytest.fixture
def recorded_axes(monkeypatch):
    """Every Axes the JAX examples create, in order."""
    created = []

    def subplots(nrows=1, ncols=1, **kw):
        axes = np.empty(nrows * ncols, dtype=object)
        for i in range(axes.size):
            axes[i] = _Axes()
        created.extend(axes)
        if axes.size == 1:
            return _Axes(), axes[0]
        return _Axes(), (axes.reshape(nrows, ncols) if min(nrows, ncols) > 1
                         else axes)

    import matplotlib.pyplot as plt
    monkeypatch.setattr(plt, "subplots", subplots)
    return created


def test_plt_cond_matches_jax(recorded_axes):
    jax_cond.main(out_png=os.devnull)
    gamma_vec, maps = plt_cond.compute(device="cpu")
    assert len(recorded_axes) == 2 * len(maps)
    for row, (cond_map, lkd_map) in enumerate(maps.values()):
        want_cond = recorded_axes[2 * row].args_of("contourf")[0][2]
        want_lkd = recorded_axes[2 * row + 1].args_of("contourf")[0][2]
        np.testing.assert_allclose(cond_map, want_cond, atol=1e-6)
        lo, hi = np.nanmin(lkd_map), np.nanmax(lkd_map)
        np.testing.assert_allclose((lkd_map - lo) / max(hi - lo, 1e-30),
                                   want_lkd, rtol=1e-7, atol=1e-10)
        assert np.array_equal(np.isnan(lkd_map), np.isnan(want_lkd))


def test_plt_nugget_1d_matches_jax(recorded_axes):
    jax_nugget.main(out_png=os.devnull)
    gamma_vec, conds = plt_nugget_1d.compute(device="cpu")
    (ax,) = recorded_axes
    want = ax.args_of("loglog")
    assert len(want) == len(conds) == 3
    for (g_want, c_want), c in zip(want, conds.values()):
        np.testing.assert_array_equal(gamma_vec, g_want)
        np.testing.assert_allclose(np.log10(c), np.log10(c_want), atol=1e-6)


def test_plt_kern_corr_matches_jax(recorded_axes):
    jax_kern_corr.main(out_png=os.devnull)
    r, corr = plt_kern_corr.compute(device="cpu")
    for k, ax in enumerate(recorded_axes):
        want = ax.args_of("plot")
        assert len(want) == len(corr)
        for (r_want, v_want), (kv, dk, d2k) in zip(want, corr.values()):
            got = (kv, dk, -d2k)[k]
            np.testing.assert_array_equal(r, r_want)
            np.testing.assert_allclose(got, np.asarray(v_want), rtol=1e-10,
                                       atol=1e-12)


def test_plt_surr_1d_matches_jax(recorded_axes):
    g_j, lkd_j, idx_j = jax_surr.main(out_png=os.devnull)
    res = plt_surr_1d.compute(device="cpu")
    np.testing.assert_array_equal(res["gamma_vec"], g_j)
    np.testing.assert_allclose(res["lkd_vals"], lkd_j, rtol=1e-7)
    np.testing.assert_array_equal(res["idx_max"], idx_j)   # the MLL maxima
    for k, ax in enumerate(recorded_axes[1:]):
        mu_j = ax.args_of("plot")[2][1]
        _, lo, hi = ax.args_of("fill_between")[0]
        sig_j = (hi - lo) / 4
        np.testing.assert_allclose(res["mu"][k], mu_j, rtol=0,
                                   atol=1e-5 * np.max(np.abs(mu_j)))
        np.testing.assert_allclose(res["sig"][k], sig_j, rtol=0,
                                   atol=1e-5 * np.max(sig_j))


def test_plt_acq_matches_jax(recorded_axes):
    jax_acq.main(out_png=os.devnull)
    res = plt_acq.compute(device="cpu")
    ucb_j, ei_j = (a[1] for a in recorded_axes[1].args_of("plot"))
    for got, want in ((res["ucb"], ucb_j), (res["ei"], ei_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-3 * np.max(np.abs(want)))


def test_run_paper_traces_worker_matches_jax(tmp_path, capsys):
    """One Precondition worker at d=2 for 2 iterations in each package:
    the per-start npz has the JAX worker's schema and initial design, and
    the merged file loads through the port's PltOptzResults."""
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for v in dirs.values():
        v.mkdir()
    jax_traces.run_one(2, "Precondition", 0, 2, str(dirs["jax"]))
    run_paper_traces.run_one(2, "Precondition", 0, 2, str(dirs["port"]),
                             device="cpu")
    z = {k: np.load(run_paper_traces.start_path(str(v), 2, "Precondition",
                                                0)) for k, v in dirs.items()}
    assert sorted(z["port"].files) == sorted(z["jax"].files)
    for key in z["jax"].files:
        assert z["port"][key].shape == z["jax"][key].shape, key
        assert z["port"][key].dtype == z["jax"][key].dtype, key
    n_init = 2 + 2
    np.testing.assert_array_equal(z["port"]["x_all"][:n_init],
                                  z["jax"]["x_all"][:n_init])
    np.testing.assert_array_equal(z["port"]["merit_all"][:n_init],
                                  z["jax"]["merit_all"][:n_init])
    assert bool(z["port"]["completed"])

    run_paper_traces.merge(2, str(dirs["port"]), 1, ["Precondition"])
    merit, opt, fsb = PltOptzResults.load_npz_data(
        str(dirs["port"]), ["Rosen_a10_d2_Precondition_all.npz"],
        n_iter_max=None)
    assert merit.shape == (1, 1, n_init + 2)
    assert np.all(np.isfinite(merit)) and np.all(np.isfinite(opt))
    names, *_ = run_paper_traces.summarize(2, str(dirs["port"]),
                                           ["Precondition"])
    assert names == ["Precondition"]
    # --ref-data: the paper's traces, here the merged file under the
    # paper's file name, are summarized beside ours
    ref = tmp_path / "ref" / "Rosen_a10_d2"
    ref.mkdir(parents=True)
    (dirs["port"] / "Rosen_a10_d2_Precondition_all.npz").rename(
        ref / run_paper_traces.REF_FILES["Precondition"])
    run_paper_traces.merge(2, str(dirs["port"]), 1, ["Precondition"])
    capsys.readouterr()
    run_paper_traces.summarize(2, str(dirs["port"]), ["Precondition"],
                               ref_data=str(tmp_path / "ref"))
    out = capsys.readouterr().out
    assert "[ours]  Precondition" in out and "[paper] Precondition" in out


def test_optz_paper_precon_compute(tmp_path):
    merit, opt = optz_paper_precon.compute(
        dim=2, n_iter=2, n_x0=1, methods=("Precondition",),
        out_dir=str(tmp_path), device="cpu")
    assert merit.shape == (1, 1, 6) and np.all(np.isfinite(merit))


def test_run_paper_traces_default_out_dir_is_the_ports():
    # results_data/full_* holds the JAX package's committed traces
    out = run_paper_traces.build_parser().parse_args([]).out_dir
    assert not os.path.normpath(out).startswith(
        os.path.join("results_data", "full_"))


def _jax_large_n_demo(n, dim, steps):
    """examples/large_n_demo.py's fit and predict (main, :50-106) on the
    JAX package's 8-device mesh, each objective and the predict jitted;
    also returns each step's probes (the key's split, in the point-major
    layout)."""
    import jax
    import jax.numpy as jnp
    import gpgradpy_tpu as jgp
    from gpgradpy_tpu.bo.problems import rosenbrock
    from gpgradpy_tpu.model import conditioning, likelihood_iter, predict_iter
    from gpgradpy_tpu.parallel import sharded_matvec as sm
    mesh = sm.make_data_mesh()
    n -= n % mesh.size
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (n, dim))
    f, g = rosenbrock(x)
    xq = rng.uniform(-2, 2, (64, dim))
    cfg = jgp.GpConfig(dim=dim, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon", cond_max_target=1e6)
    spec = jgp.make_data_spec(dim, True, n, std_fval=np.zeros(n),
                              std_grad=np.zeros((n, dim)))
    data = jgp.GpData(x=jnp.asarray(x), fval=jnp.asarray(f),
                      std_fval=jnp.zeros(n), grad=jnp.asarray(g),
                      std_grad=jnp.zeros((n, dim)))
    eta = conditioning.calc_etaK(cfg, n)
    obj = jax.jit(lambda th, k: likelihood_iter.neg_mll_iterative_and_grad(
        cfg, spec, data, jgp.Hypers(theta=th), eta, k, n_probes=8,
        max_cg_iters=400, cg_tol=1e-8, mesh=mesh)[:2])
    log_theta = jnp.zeros(dim) - 1.0
    key = jax.random.PRNGKey(0)
    trace, probes = [], []
    for it in range(steps):
        k = jax.random.fold_in(key, it)
        probes.append(np.asarray(jax.random.rademacher(
            jax.random.split(k, 1)[0], (n * (1 + dim), 8),
            dtype=jnp.float64)))
        val, gth = obj(10.0 ** log_theta, k)
        glog = gth * (10.0 ** log_theta) * np.log(10.0)
        log_theta = jnp.clip(log_theta - 0.15 * jnp.clip(glog, -1.0, 1.0),
                             -4.0, 2.0)
        trace.append(float(val))
    mu, sig, *_ = jax.jit(lambda th, q: predict_iter.predict_iterative(
        cfg, spec, data, jgp.Hypers(theta=th), eta, q, max_cg_iters=300,
        mesh=mesh))(10.0 ** log_theta, jnp.asarray(xq))
    return dict(neg_lnL=trace, theta=np.asarray(10.0 ** log_theta),
                mu=np.asarray(mu), sig=np.asarray(sig)), probes


def test_large_n_demo_matches_jax():
    """The demo's compute part at n=32, d=2, 3 steps on a group of one rank,
    with the JAX example's probes, against the JAX example's fit and
    predict on its 8-device mesh: theta to rtol 1e-8, mu to rtol 1e-7
    (atol 1e-9) and sig to rtol 1e-5 (atol 1e-9), the tolerances of the
    iterative tests.  -ln L at each step to rtol 5e-8: each step's clipped
    update keeps theta bitwise equal in both packages, so -ln L differs
    only through its CG solves, which stop at a relative residual of 1e-8
    (the demo's cg_tol), and through the Lanczos quadrature of the
    iterations they ran (readings over the four BLAS paths of MKL and ATen:
    <= 1.3e-8)."""
    want, probes = _jax_large_n_demo(32, 2, 3)
    got = large_n_demo.compute(32, 2, 3, device="cpu",
                               probes=lambda it, n_full: probes[it],
                               verbose=False)
    assert got["world_size"] == 1 and got["backend"] == "gloo"
    assert got["n_eval"] == 32 and got["predict_cg_resid"] < 1e-8
    np.testing.assert_allclose(got["neg_lnL"], want["neg_lnL"], rtol=5e-8)
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=1e-8)
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got["sig"], want["sig"], rtol=1e-5, atol=1e-9)


def test_scaling_harness_matches_jax():
    """The harness at world sizes 1 and 2 (spawned gloo groups) with 4
    chains, 4 + 4 transitions and 4 starts: the JSON's fields, each point's
    best start against the JAX package's multistart solver on the same
    starts (rtol 1e-8, tests/test_sharding.py's criterion), and no 70%
    claim from ranks that share the CPU.  The sampler across the world
    sizes: every tree of every sampling transition of the same size, and
    the chains' mean after the 8 transitions to rtol 1e-7.  The mean moves
    with the round-off of the log posterior, whose value and gradient for
    4 chains in one batch and for two ranks' batches of 2 lie 7.4e-10 and
    2.0e-8 apart (of their largest entry, at points where the chains run;
    held to 5e-9 and 1e-7); the mean reads <= 3.4e-8 apart (both over the
    four BLAS paths of MKL and ATen)."""
    import jax.numpy as jnp
    import gpgradpy_tpu as jgp
    from gpgradpy_tpu.fit import lhs, multistart
    from gpgradpy_tpu.model import conditioning
    with pytest.raises(ValueError, match="divide"):
        scaling_harness.compute((3,), chains=4, starts=4, device="cpu")
    res = scaling_harness.compute((1, 2), chains=4, samples=4, warmup=4,
                                  starts=4, device="cpu")
    assert res["backend"] == "gloo" and res["platform"] == "cpu"
    assert [p["world_size"] for p in res["points"]] == [1, 2]
    assert all(p["shared_device"] for p in res["points"])
    assert res["meets_70pct_target"] is False
    assert res["points"][0]["nuts_eff"] == 1.0
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (24, 2))
    cfg = jgp.GpConfig(dim=2, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon")
    spec = jgp.make_data_spec(2, True, 24, std_fval=np.zeros(24),
                              std_grad=np.zeros((24, 2)))
    data = jgp.GpData(x=jnp.asarray(x), fval=jnp.asarray(
        np.sum((x - 0.3) ** 2, axis=1)), std_fval=jnp.zeros(24),
        grad=jnp.asarray(2.0 * (x - 0.3)), std_grad=jnp.zeros((24, 2)))
    lb, ub = np.full(2, -4.0), np.full(2, 2.0)
    f_jax = multistart._jit_solver(cfg, spec, jgp.HpInfo(dim=2), 50, 1e-12)(
        jnp.asarray(lhs.lhs_sample(4, lb + 0.5, ub - 0.5, 3)),
        jnp.asarray(lb), jnp.asarray(ub), data,
        conditioning.calc_etaK(cfg, 24)).f
    for pt in res["points"]:
        np.testing.assert_allclose(pt["fit_best_f"], np.min(np.asarray(f_jax)),
                                   rtol=1e-8)
        assert pt["nuts_samples_per_s"] > 0 and pt["fit_starts_per_s"] > 0
    one, two = res["points"]
    assert np.shape(one["nuts_n_leapfrog"]) == (4, 4)
    assert two["nuts_n_leapfrog"] == one["nuts_n_leapfrog"]
    np.testing.assert_allclose(two["nuts_mean_z"], one["nuts_mean_z"],
                               rtol=1e-7)
    from gpgradpy_torch.inference import nuts
    cfg, spec, info, data, eta = scaling_harness._problem(
        torch.device("cpu"))
    lg = nuts.value_and_grad(nuts.make_gp_logpost(
        cfg, spec, info, data, eta, np.full(info.n_hp, scaling_harness.LB_HP),
        np.full(info.n_hp, scaling_harness.UB_HP))[0])
    # points where the chains run (their mean is ~-0.55 in each coordinate)
    z = torch.as_tensor(np.random.default_rng(1).normal(-0.55, 0.3,
                                                        (4, info.n_hp)))
    whole, halves = lg(z), [lg(z[:2]), lg(z[2:])]
    for k, tol in ((0, 5e-9), (1, 1e-7)):
        want = whole[k].numpy()
        np.testing.assert_allclose(torch.cat([h[k] for h in halves]).numpy(),
                                   want, rtol=0.0,
                                   atol=tol * np.abs(want).max())


def _run_example(name, tmp_path, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", f"gpgradpy_torch.examples.{name}",
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=timeout, cwd=tmp_path, env=env)
    assert p.returncode == 0, f"{name} failed:\n{p.stdout}\n{p.stderr}"
    assert (tmp_path / f"{name}.png").stat().st_size > 0
    return p.stdout


@pytest.mark.slow
def test_plt_kern_corr_script(tmp_path):
    assert "saved" in _run_example("plt_kern_corr", tmp_path)


@pytest.mark.slow
def test_plt_surr_1d_script(tmp_path):
    assert "local MLL maxima" in _run_example("plt_surr_1d", tmp_path)


@pytest.mark.slow
def test_plt_acq_script(tmp_path):
    assert "saved" in _run_example("plt_acq", tmp_path)


@pytest.mark.slow
def test_plt_cond_script(tmp_path):
    assert "saved" in _run_example("plt_cond", tmp_path)


@pytest.mark.slow
def test_plt_nugget_1d_script(tmp_path):
    assert "saved" in _run_example("plt_nugget_1d", tmp_path)
