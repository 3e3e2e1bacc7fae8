"""Parity of the port's multi-device layer (gpgradpy_torch/parallel, the
mesh branches of the model and fit modules, solver='dense_dist',
sample_posterior(use_mesh=True)) with the JAX package on its 8-virtual-
device CPU mesh (tests/conftest.py), in float64.

The port runs at world size 1 in this process and at world sizes 2 and 4 in
spawned gloo process groups, every multi-rank check of one world size in
one job (tests/torch_parallel_jobs.py), each job with its own timeout so
that a deadlocked collective fails the test.  Every result must be the
same on every rank.  Tolerances, each stated where it is checked: the
layout helpers bitwise; the matvec within 1e-12 of max|out| of the JAX
package's and of the dense covariance's, its theta gradient rtol 1e-10 of
jax.grad's; the distributed Cholesky rtol 1e-9 / atol 1e-11, its logdet
rtol 1e-10 (the JAX test's), cholesky_ok_dist's value and VJP within 1e-10
of max|.| of the JAX package's; the MLL with the mesh rtol 1e-10 (value) and
1e-8 (gradient) of the JAX package's with the mesh (two LAPACKs, ROADMAP
Queue 3); the iterative MLL, noisy MLL and predict at the tolerances of the
mesh-free tests in test_torch_iterative.py; the dense_dist fit theta rtol
1e-5 and mu rtol 1e-6 (tests/test_dense_dist.py's criteria), the padded
fit held to the port's dense fit's -ln L (rtol 1e-6); the sharded
multistart's minimum f rtol 1e-8 (tests/test_sharding.py's criterion);
sharded NUTS within 1e-12 of one process's pooled run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpgradpy_tpu as jgp
from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_tpu.fit import multistart as jms
from gpgradpy_tpu.model import conditioning as jcond
from gpgradpy_tpu.model import likelihood as jlkd
from gpgradpy_tpu.model import likelihood_iter as jli
from gpgradpy_tpu.model import predict_iter as jpi
from gpgradpy_tpu.ops import kernels as jkernels
from gpgradpy_tpu.ops import linalg as jlinalg
from gpgradpy_tpu.ops import rtensor as jrtensor
from gpgradpy_tpu.parallel import sharded_matvec as jsm
from gpgradpy_tpu.parallel.chol_dist import cholesky_dist as jchol_dist
from gpgradpy_torch.inference import nuts
from gpgradpy_torch.inference.draws import Draws
from gpgradpy_torch.parallel import sharded_matvec as sm
from gpgradpy_torch.parallel.mesh import local_slice, run_spawned

import torch_parallel_jobs as jobs

WORLDS = (2, 4)
# seconds for one world size's job, a deadlock guard: 3x world 4's 86 s in a
# run of the whole suite, six workers on 8 cores (world 2's took 47 s)
SPAWN_TIMEOUT = 260
N_PROBES = 8
ITER_KW = dict(max_cg_iters=300)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def close_max(got, want, rel):
    """|got - want| <= rel * max|want|."""
    want = np.asarray(want)
    close(got, want, rtol=0, atol=rel * np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# the JAX package's results, once per module
# ---------------------------------------------------------------------------

def _jax_problem(x, f, g, noisy, cond=None, **cfg_kw):
    n, dim = x.shape
    extra = {} if cond is None else dict(cond_max_target=cond, cond_max=cond)
    cfg = jgp.GpConfig(dim=dim, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon", **extra, **cfg_kw)
    z = None if noisy else np.zeros(n)
    zg = None if noisy else np.zeros((n, dim))
    spec = jgp.make_data_spec(dim, True, n, std_fval=z, std_grad=zg)
    arr = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    data = jgp.GpData(x=arr(x), fval=arr(f), std_fval=arr(z), grad=arr(g),
                      std_grad=arr(zg))
    return cfg, spec, data


@pytest.fixture(scope="module")
def mesh8():
    mesh = jsm.make_data_mesh()
    assert mesh.size == 8
    return mesh


@pytest.fixture(scope="module")
def probes():
    """The JAX package's probes of each iterative problem (the key's split,
    likelihood_iter.py:229), drawn in its point-major working layout."""
    out = {}
    for name, (x, *_) in jobs.iter_problems().items():
        if name == "xq":
            continue
        n_full = x.shape[0] * (1 + x.shape[1])
        out[name] = np.asarray(jax.random.rademacher(
            jax.random.split(jax.random.PRNGKey(0), 1)[0],
            (n_full, N_PROBES), dtype=jnp.float64))
    return out


@pytest.fixture(scope="module")
def jax_refs(mesh8, probes):
    ref = {}
    # the sharded matvec, its batch and theta gradient
    p = jobs.matvec_problem()
    x, th = jnp.asarray(p["x"]), jnp.asarray(p["theta"])
    n, dim = p["x"].shape
    K = jkernels.kern_grad("SqExp", jrtensor.calc_rtensor(x, x), th)
    p2 = jnp.diagonal(K)
    xs = jsm.shard_points(mesh8, x)
    ref["mv1"] = np.asarray(jax.jit(lambda v, p2_pm: jsm.kern_matvec_sharded(
        "SqExp", mesh8, xs, th, None, v, eta=p["eta"], pvec2_pm=p2_pm))(
            *jsm.shard_points(mesh8, jnp.asarray(p["v_pm"]),
                              jsm.blocked_to_pointmajor(p2, n, dim))))
    v_b = np.asarray(jsm.pointmajor_to_blocked(jnp.asarray(p["v_pm"])))
    ref["mv1_dense"] = np.asarray(jsm.blocked_to_pointmajor(
        (K + p["eta"] * jnp.diag(p2)) @ v_b, n, dim))
    for kt in jobs.FAMILIES:
        al = jobs.ALPHA[kt]

        def out(theta, kt=kt, al=al):
            return jsm.kern_matvec_sharded_batch(
                kt, mesh8, xs, theta, al, jnp.asarray(p["V_pm"]))
        ref[f"mvb_{kt}"] = np.asarray(jax.jit(out)(th))
        Kk = jkernels.kern_grad(kt, jrtensor.calc_rtensor(x, x), th, al)
        ref[f"mvb_{kt}_dense"] = np.asarray(jsm.blocked_to_pm_mat(
            Kk @ jsm.pm_to_blocked_mat(jnp.asarray(p["V_pm"]), n, dim),
            n, dim))
        ref[f"mvg_{kt}"] = np.asarray(jax.jit(jax.grad(
            lambda t: jnp.sum(jnp.asarray(p["G_pm"]) * out(t))))(th))
    # the distributed Cholesky and its custom-VJP wrapper
    for n_c, block in jobs.CHOL_CASES:
        L, logdet = jchol_dist(mesh8, jnp.asarray(jobs.spd_geom(n_c)),
                               block=block)
        ref[f"chol_{n_c}_L"] = np.asarray(L)
        ref[f"chol_{n_c}_logdet"] = float(logdet)
    A, C = jobs.spd_gram(256)
    ref["chol_ok_L"] = np.asarray(jlinalg.cholesky_ok_dist(
        jnp.asarray(A), mesh8, block=16).L)
    ref["chol_ok_vjp"] = np.asarray(jax.grad(lambda M: jnp.sum(
        jlinalg.cholesky_ok_dist(M, mesh8, block=16).L * C))(jnp.asarray(A)))
    # the MLL with the mesh (tests/test_dense_dist.py::test_mll_grad_mesh_vs_dense)
    x, f, g = jobs.rosen_problem(32, 3)
    cfg, spec, data = _jax_problem(x, f, g, False, dist_chol_block=16)
    val, grad, _ = jax.jit(lambda v: jlkd.neg_mll_and_grad(
        cfg, spec, jgp.HpInfo(dim=3), data, v, jcond.calc_etaK(cfg, 32),
        mesh=mesh8))(jnp.asarray(np.log10(np.full(3, 0.7))))
    ref["mll_val"], ref["mll_grad"] = float(val), np.asarray(grad)
    # the iterative MLL, noisy MLL and predict with the mesh
    probs = jobs.iter_problems()
    key = jax.random.PRNGKey(0)
    kw = dict(ITER_KW, mesh=mesh8)
    for name in ("mll", "noisy"):
        x, f, g, noisy, hp = probs[name]
        cfg, spec, data = _jax_problem(x, f, g, noisy, cond=1e4)
        eta = jcond.calc_etaK(cfg, x.shape[0])
        hpj = jgp.Hypers(**{k: jnp.asarray(v) for k, v in hp.items()})
        calc, grad = ((jli.calc_lkd_iterative_noisy,
                       jli.neg_mll_iterative_noisy_and_grad) if noisy else
                      (jli.calc_lkd_iterative, jli.neg_mll_iterative_and_grad))
        lkd = jax.jit(lambda h: calc(cfg, spec, data, h, eta, key,
                                     n_probes=N_PROBES, **kw))(hpj)
        val, gh, _ = jax.jit(lambda h: grad(cfg, spec, data, h, eta, key,
                                            n_probes=N_PROBES, **kw))(hpj)
        for k in ("ln_lkd", "beta", "varK", "cg_iters"):
            ref[f"{name}_{k}"] = np.asarray(getattr(lkd, k))
        ref[f"{name}_val"] = float(val)
        ref[f"{name}_grad"] = np.asarray(gh.theta if noisy else gh)
        if noisy:
            ref[f"{name}_grad_varK"] = np.asarray(gh.varK)
    x, f, g, noisy, hp = probs["predict"]
    cfg, spec, data = _jax_problem(x, f, g, noisy, cond=1e4)
    eta = jcond.calc_etaK(cfg, x.shape[0])
    mu, sig, *_ = jax.jit(lambda h, q: jpi.predict_iterative(
        cfg, spec, data, h, eta, q, **kw))(
            jgp.Hypers(theta=jnp.asarray(hp["theta"])),
            jnp.asarray(probs["xq"]))
    ref["pred_mu"], ref["pred_sig"] = np.asarray(mu), np.asarray(sig)
    # the dense_dist facade fit on the grid (128 rows = 8 devices x 16)
    x, f, g = jobs.rosen_problem(32, 3)
    gp = JaxGP(3, True, "SqExp", "precon", dtype="float64",
               solver="dense_dist", dist_chol_block=16, cond_norm="fro")
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(32), g, np.zeros((32, 3)))
    gp.set_hpara("optz", 0)
    ref["dd32_theta"] = np.asarray(gp.hp_vals.theta)
    ref["dd32_mu"] = gp.eval_model(
        np.random.default_rng(9).uniform(-1.5, 1.5, (6, 3)))[0]
    # the multistart solver's minimum (tests/test_sharding.py)
    x, f, g, x0 = jobs.sharding_problem()
    cfg, spec, data = _jax_problem(x, f, g, False)
    res = jms._jit_solver(cfg, spec, jgp.HpInfo(dim=2), 50, 1e-12)(
        jnp.asarray(x0), jnp.full(2, -6.0), jnp.full(2, 4.0), data,
        jcond.calc_etaK(cfg, 6))
    ref["ms_f"] = np.asarray(res.f)
    return ref


@pytest.fixture(scope="module")
def ranks(probes):
    """Every check on world sizes 2 and 4: {world: [results of each rank]}."""
    return {w: run_spawned(jobs.all_checks, w, "cpu", (probes,),
                           timeout=SPAWN_TIMEOUT) for w in WORLDS}


@pytest.fixture(scope="module")
def world1(probes):
    """The matvec and Cholesky checks on a group of one rank in this
    process (make_data_mesh's default: a world-size-1 gloo group)."""
    mesh = sm.make_data_mesh(device="cpu")
    assert mesh.size == 1 and mesh.backend == "gloo"
    out = jobs.matvec_checks(mesh)
    out.update(jobs.chol_checks(mesh))
    return out


def _results(ranks, world1, world):
    if world == 1:
        return world1
    return ranks[world][0]


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_layout_helpers_are_bitwise_the_jax_packages():
    rng = np.random.default_rng(3)
    n, dim, m = 8, 3, 5
    M = rng.standard_normal((n * (1 + dim), m))
    v = rng.standard_normal(n * (1 + dim))
    V = rng.standard_normal((n, 1 + dim))
    for got, want in (
            (sm.blocked_to_pm_mat(torch.as_tensor(M), n, dim),
             jsm.blocked_to_pm_mat(jnp.asarray(M), n, dim)),
            (sm.blocked_to_pm_mat(torch.as_tensor(v), n, dim),
             jsm.blocked_to_pm_mat(jnp.asarray(v), n, dim)),
            (sm.pm_to_blocked_mat(torch.as_tensor(M), n, dim),
             jsm.pm_to_blocked_mat(jnp.asarray(M), n, dim)),
            (sm.pm_to_blocked_mat(torch.as_tensor(v), n, dim),
             jsm.pm_to_blocked_mat(jnp.asarray(v), n, dim)),
            (sm.blocked_to_pointmajor(torch.as_tensor(v), n, dim),
             jsm.blocked_to_pointmajor(jnp.asarray(v), n, dim)),
            (sm.pointmajor_to_blocked(torch.as_tensor(V)),
             jsm.pointmajor_to_blocked(jnp.asarray(V)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gets_the_same_results(ranks, world):
    """The whole vectors, factors, fits and samples: bitwise the same on
    every rank (a rank that decided differently on the host would have
    deadlocked at the next collective)."""
    first = ranks[world][0]
    for other in ranks[world][1:]:
        for k, v in first.items():
            if not k.startswith("seconds_"):
                np.testing.assert_array_equal(np.asarray(other[k]),
                                              np.asarray(v), err_msg=k)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_sharded_matvec_matches_jax(jax_refs, ranks, world1, world):
    """kern_matvec_sharded (eta P^2 term) and kern_matvec_sharded_batch (3
    families, ragged row tiles of 6 points) within 1e-12 of max|out| of the
    JAX package's sharded matvec and of the dense covariance's product; the
    theta gradient through ShardedMatvecFn (K2's plain version per tile,
    then the all_reduce) rtol 1e-10 of jax.grad through the JAX one: a
    gradient counted world-size times would miss it."""
    r = _results(ranks, world1, world)
    close_max(r["mv1"], jax_refs["mv1"], 1e-12)
    close_max(r["mv1"], jax_refs["mv1_dense"], 1e-12)
    for kt in jobs.FAMILIES:
        close_max(r[f"mvb_{kt}"], jax_refs[f"mvb_{kt}"], 1e-12)
        close_max(r[f"mvb_{kt}"], jax_refs[f"mvb_{kt}_dense"], 1e-12)
        close(r[f"mvg_{kt}"], jax_refs[f"mvg_{kt}"], rtol=1e-10)


@pytest.mark.parametrize("world", (1,) + WORLDS)
def test_cholesky_dist_matches_jax(jax_refs, ranks, world1, world):
    """cholesky_dist at (n, block) = (256, 32) and (384, 16): the factor
    rtol 1e-9 / atol 1e-11 of the JAX package's and numpy's, logdet rtol
    1e-10 of slogdet (tests/test_chol_dist.py); cholesky_ok_dist's factor
    and symmetrized VJP within 1e-10 of max|.| of the JAX package's."""
    r = _results(ranks, world1, world)
    for n, _ in jobs.CHOL_CASES:
        A = jobs.spd_geom(n)
        close(r[f"chol_{n}_L"], jax_refs[f"chol_{n}_L"], rtol=1e-9,
              atol=1e-11)
        close(r[f"chol_{n}_L"], np.linalg.cholesky(A), rtol=1e-9, atol=1e-11)
        close(r[f"chol_{n}_logdet"], np.linalg.slogdet(A)[1], rtol=1e-10)
    assert r["chol_ok"]
    close_max(r["chol_ok_L"], jax_refs["chol_ok_L"], 1e-10)
    close_max(r["chol_ok_vjp"], jax_refs["chol_ok_vjp"], 1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_mll_with_the_mesh_matches_jax(jax_refs, ranks, world):
    """-ln L and its hp gradient through the distributed Cholesky (K1
    assembly, CholDistFn's pullback): rtol 1e-10 and 1e-8 of the JAX
    package's with its mesh."""
    r = ranks[world][0]
    assert r["mll_ok"]
    close(r["mll_val"], jax_refs["mll_val"], rtol=1e-10)
    close(r["mll_grad"], jax_refs["mll_grad"], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_iterative_with_the_mesh_matches_jax(jax_refs, ranks, world):
    """With the JAX package's probes in the point-major layout: ln L, beta,
    varK (rtol 1e-8) of the noise-free and noisy MLL, -ln L (1e-8) and its
    determinant-free gradient (rtol 1e-6; theta and varK in the noisy
    regime), and the predict's mu (rtol 1e-7, atol 1e-9) and sig (rtol
    1e-5, atol 1e-9): the mesh-free tests' tolerances.  The CG count: equal
    on the noise-free problem (221 iterations); on the noisy one CG runs
    past its 48 rows (122 in the JAX package), where round-off in the last
    residuals decides the stop, and the two packages stop within 5 of each
    other (test_torch_iterative.py holds counts at cond 1e2 for that
    reason)."""
    r = ranks[world][0]
    for name in ("mll", "noisy"):
        for k in ("ln_lkd", "beta", "varK"):
            close(r[f"{name}_{k}"], jax_refs[f"{name}_{k}"], rtol=1e-8)
        assert float(r[f"{name}_cg_resid"]) < 1e-8
    assert int(r["mll_cg_iters"]) == int(jax_refs["mll_cg_iters"])
    assert abs(int(r["noisy_cg_iters"]) - int(jax_refs["noisy_cg_iters"])) <= 5
    for name in ("mll", "noisy"):
        close(r[f"{name}_val"], jax_refs[f"{name}_val"], rtol=1e-8)
        close(r[f"{name}_grad"], jax_refs[f"{name}_grad"], rtol=1e-6)
    close(r["noisy_grad_varK"], jax_refs["noisy_grad_varK"], rtol=1e-6)
    assert r["pred_resid"] < 1e-8
    close(r["pred_mu"], jax_refs["pred_mu"], rtol=1e-7, atol=1e-9)
    close(r["pred_sig"], jax_refs["pred_sig"], rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_dense_dist_fit_matches_jax(jax_refs, ranks, world):
    """The facade's solver='dense_dist' on 128 rows (on the grid of every
    world size here and of the JAX package's 8 devices): theta rtol 1e-5,
    mu rtol 1e-6 (tests/test_dense_dist.py).  At n_eval=27 the port pads
    onto its own world_size x 16 grid (the JAX package onto 8 x 16), so
    that fit is held to the port's dense fit on the same data: -ln L rtol
    1e-6, theta 1e-5, mu 1e-6."""
    r = ranks[world][0]
    assert r["dd32_mesh"] == world and r["dd32_n_data_tot"] == 128
    close(r["dd32_theta"], jax_refs["dd32_theta"], rtol=1e-5)
    close(r["dd32_mu"], jax_refs["dd32_mu"], rtol=1e-6, atol=1e-10)
    assert r["dd27_n_data_tot"] % (world * 16) == 0
    assert r["dd27_n_data_tot"] - 27 * 4 < world * 16
    dense = jobs._facade(*jobs.rosen_problem(27, 3), "dense",
                         cond_norm="fro")
    close(r["dd27_lnL"], dense.history.ln_lkd[0], rtol=1e-6)
    close(r["dd27_theta"], dense.hp_vals.theta.numpy(), rtol=1e-5)
    close(r["dd27_mu"], dense.eval_model(
        np.random.default_rng(9).uniform(-1.5, 1.5, (6, 3)))[0], rtol=1e-6,
        atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_iterative_fit_with_the_mesh_matches_the_mesh_free_fit(ranks, world):
    """fit_map_iterative with the mesh and the same probes (permuted to the
    point-major layout) against the mesh-free fit in this process: the
    same number of objective calls, -ln L rtol 1e-10 and hp within 1e-8
    (the layouts differ by a permutation, which changes only the order of
    the sums)."""
    r = ranks[world][0]
    want = jobs.iter_fit()
    assert r["iter_fit_nval"] == want.info["optz_n_val"]
    close(r["iter_fit_f"], want.neg_lkd, rtol=1e-10)
    close(r["iter_fit_hp"], want.hp_vec, rtol=0, atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_multistart_matches_single_process(jax_refs, ranks, world):
    """16 starts split over the ranks: the best f equals this process's and
    the JAX package's to rtol 1e-8, and at least 3/4 of the starts end at
    the same f (rtol 1e-8) as in this process (tests/test_sharding.py's
    criteria: a batch of another size rounds differently, and the
    optimizer sits on a flat optimum)."""
    r = ranks[world][0]
    close(np.min(r["ms_f"]), np.min(jax_refs["ms_f"]), rtol=1e-8)
    close(np.min(r["ms_f"]), np.min(r["ms_f_single"]), rtol=1e-8)
    assert np.mean(np.isclose(r["ms_f"], r["ms_f_single"], rtol=1e-8)) >= 0.75


@pytest.fixture(scope="module")
def pooled_single():
    return nuts.run_nuts(jobs.gauss_logp, jobs.t64(jobs.NUTS_Z0), Draws(5),
                         cross_chain_mean=nuts.chain_mean, **jobs.NUTS_KW)


@pytest.mark.parametrize("world", WORLDS)
def test_run_nuts_sharded_equals_pooled_run_nuts(ranks, pooled_single,
                                                 world):
    """4 chains on 2 or 4 ranks with pooled adaptation: samples and
    diagnostics within 1e-12 of one process running every chain with
    cross_chain_mean=chain_mean (the pooled mean's last bits differ), and
    the tree sizes equal.  Without each rank's chain-stream offset rank
    1's chains would draw rank 0's numbers."""
    r = ranks[world][0]
    zs, diag = pooled_single
    close(r["nuts_z"], zs.numpy(), rtol=0, atol=1e-12)
    for k in ("step_size", "inv_mass", "logp", "accept_prob"):
        close(r[f"nuts_{k}"], diag[k].numpy(), rtol=0, atol=1e-12)
    for k in ("n_leapfrog", "diverging"):
        np.testing.assert_array_equal(r[f"nuts_{k}"], diag[k].numpy())


def test_draws_chain_offset_gives_each_chain_its_global_stream():
    """A chain run alone with Draws(seed, chain_offset=1) is chain 1 of the
    pair run together (per-chain adaptation): bitwise, samples and
    diagnostics."""
    kw = dict(n_warmup=20, n_samples=15, max_depth=5)
    z0 = jobs.t64(jobs.NUTS_Z0[:2])
    zs, diag = nuts.run_nuts(jobs.gauss_logp, z0, Draws(3), **kw)
    zs1, diag1 = nuts.run_nuts(jobs.gauss_logp, z0[1:], Draws(3, "cpu", 1),
                               **kw)
    assert torch.equal(zs1[0], zs[1])
    for k in diag:
        assert torch.equal(diag1[k][0], diag[k][1]), k
    zs0, _ = nuts.run_nuts(jobs.gauss_logp, z0[1:], Draws(3), **kw)
    assert not torch.equal(zs0[0], zs[1])


def test_sample_posterior_use_mesh_is_pooled_run_nuts():
    """sample_posterior(use_mesh=True) on a group of one rank: the samples
    of run_nuts over the same starts and streams with pooled adaptation
    (1e-12), which differs from use_mesh=False's per-chain adaptation (the
    JAX package's own difference)."""
    from gpgradpy_torch import GaussianProcess
    x, f, g = jobs.rosen_problem(6, 2)
    gp = GaussianProcess(2, True, device="cpu")
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(6), g, np.zeros((6, 2)))
    gp.set_hpara("optz", 0)
    kw = dict(n_warmup=8, n_samples=6, max_depth=4)
    hp_mesh, diag = gp.sample_posterior(4, seed=2, use_mesh=True, **kw)
    logpost, z_to_hp, z0 = gp._posterior_setup(4, 2)
    zs, _ = nuts.run_nuts(logpost, z0, Draws(2), cross_chain_mean=nuts.chain_mean,
                          **kw)
    want = z_to_hp(zs).numpy()
    want[..., gp.hp_info_optz_lkd.bvec_log] = 10.0 ** want[
        ..., gp.hp_info_optz_lkd.bvec_log]
    close(hp_mesh, want, rtol=1e-12)
    assert np.ptp(diag["step_size"]) == 0.0
    _, diag_own = gp.sample_posterior(4, seed=2, **kw)
    assert np.ptp(diag_own["step_size"]) > 0.0


def test_facade_mesh_paths_on_one_rank_match_the_mesh_free_ones():
    """iter_use_mesh on a group of one rank: the closed form, setup and
    eval_model of the iterative facade at fixed hyperparameters equal the
    mesh-free facade's (the layouts differ only by a permutation; rtol
    1e-8 on mu, 1e-6 on sig, as the CG solves stop within their
    tolerance); eval_model with gradients raises (mu and sigma only, as in
    the JAX package)."""
    from gpgradpy_torch import GaussianProcess
    x, f, g = jobs.rosen_problem(16, 2)
    xq = np.random.default_rng(4).uniform(-2, 2, (5, 2))
    out = []
    for mesh in (False, True):
        gp = GaussianProcess(2, True, device="cpu", solver="iterative",
                             iter_use_mesh=mesh, cond_max_target=1e3,
                             cond_max=1e3, iter_row_block=5)
        gp.set_data(x, f, np.zeros(16), g, np.zeros((16, 2)))
        gp.set_custom_hp(theta=[0.3, 0.05])
        gp.set_hpara("current", 0)
        out.append((gp.hp_vals, gp.eval_model(xq)))
        if mesh:
            with pytest.raises(NotImplementedError, match="mu and sigma"):
                gp.eval_model(xq, calc_grad=True)
    (hp0, (mu0, sig0, *_)), (hp1, (mu1, sig1, *_)) = out
    close(hp1.varK, hp0.varK, rtol=1e-8)
    close(mu1, mu0, rtol=1e-8)
    close(sig1, sig0, rtol=1e-6)


def test_make_mesh_refuses_another_world_size():
    """A mesh is every rank of the group; a leading axis the world size
    does not divide is refused.  On one rank the shard and gather helpers
    give back their input (bool through its uint8 gather)."""
    from gpgradpy_torch.parallel.mesh import gather_batch, shard_batch
    mesh = sm.make_data_mesh(device="cpu")
    x = torch.arange(12.0).reshape(6, 2)
    assert torch.equal(sm.shard_points(mesh, x), x)
    assert torch.equal(gather_batch(shard_batch(x, mesh), mesh), x)
    b = x[:, 0] > 4
    assert torch.equal(gather_batch(b, mesh), b)
    with pytest.raises(ValueError, match="ranks"):
        sm.make_data_mesh(mesh.size + 1, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        local_slice(dataclasses.replace(mesh, size=3), 8)


def test_compact_rows_of_the_full_covariance_match_the_closed_form():
    """On the card a partial gradient set (the padding points of
    dense_dist carry no gradient rows) takes its rows and columns out of
    KernGradFn's full matrix (assembly.calc_kern): here KernGradFn on CPU
    tensors (K1's and K2's plain versions) with assembly.compact_rows
    against the closed form with idx_grad, value bitwise and theta
    gradient rtol 1e-12."""
    import gpgradpy_torch as tgp
    from gpgradpy_torch.model import assembly
    from gpgradpy_torch.ops import kernels, rtensor
    x, f, g = jobs.rosen_problem(9, 3)
    spec = tgp.make_data_spec(3, True, 7, std_fval=np.zeros(7),
                              std_grad=np.zeros((7, 3)), n_pad_eval=2)
    xt = jobs.t64(x)
    rows = assembly.compact_rows(9, 3, spec.n_eval, "cpu")
    G = jobs.t64(np.random.default_rng(2).standard_normal(
        (spec.n_data_tot, spec.n_data_tot)))
    out = []
    for fn in (lambda th: assembly.KernGradFn.apply("Ma5f2", xt, th, None)
               .index_select(-2, rows).index_select(-1, rows),
               lambda th: kernels.kern_mat(
                   "Ma5f2", rtensor.calc_rtensor(xt, xt), th, None, True,
                   spec.idx_grad_arr, spec.idx_grad_arr)):
        th = jobs.t64([0.4, 1.3, 0.7]).requires_grad_(True)
        K = fn(th)
        out.append((K.detach(), torch.autograd.grad((G * K).sum(), th)[0]))
    assert out[0][0].shape == (spec.n_data_tot, spec.n_data_tot)
    assert torch.equal(out[0][0], out[1][0])
    close(out[0][1], out[1][1], rtol=1e-12)
