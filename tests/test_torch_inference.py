"""The port's hyperparameter inference (NUTS with windowed adaptation, ADVI,
tempered SMC, diagnostics, sample_posterior) against the JAX package, in
float64 on the CPU.

torch cannot reproduce ``jax.random``, so the parity tests replay the JAX
package's key-split sequence (nuts.py:116-117, 163-164, 230-231, 244;
vi.py:31, 46; smc.py:27, 40, 58, 72-78, 83-85) through the port's draw
interface (``gpgradpy_torch.inference.draws.Draws``): the port then takes
the JAX package's transitions one for one.  The statistical tests are the
JAX package's own criteria (tests/test_inference.py, test_api_extras.py),
run on the port's generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpgradpy_tpu as jgp
from gpgradpy_tpu.inference import diagnostics as jdiag
from gpgradpy_tpu.inference import nuts as jnuts
from gpgradpy_tpu.inference import smc as jsmc
from gpgradpy_tpu.inference import vi as jvi
from gpgradpy_tpu.model import conditioning as jcond
import gpgradpy_torch as tgp
from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.fit import multistart
from gpgradpy_torch.inference import diagnostics, nuts, smc, vi
from gpgradpy_torch.inference.draws import Draws
from gpgradpy_torch.model import conditioning as tcond
from gpgradpy_torch.model import likelihood as tlkd

F64 = torch.float64
COV = np.array([[1.0, 0.8], [0.8, 2.0]])
PREC = np.linalg.inv(COV)


def _t(a):
    return torch.as_tensor(np.array(a))


def gauss_logp():
    """The correlated 2-d Gaussian of the JAX tests, in both packages."""
    jp, tp = jnp.asarray(PREC), _t(PREC)
    return (lambda z: -0.5 * z @ jp @ z,
            lambda z: -0.5 * ((z @ tp) * z).sum(-1))


def gp_problem(d=1, cond_max_target=1e10):
    """A GP hyperparameter posterior in both packages: the d=1 GP of
    tests/test_inference.py:59-81, or a d=2, n_eval=12 Rosenbrock SqExp
    problem (n_hp = d).  Returns ((jax logpost, z_to_hp), (torch logpost,
    z_to_hp), cond) with cond(hp_vec) the port's cond(M) at each row."""
    if d == 1:
        n = 8
        x = np.linspace(2.5, 7.5, n)[:, None]
        f = np.sin(x[:, 0]) + np.sin(10 * x[:, 0] / 3)
        g = (np.cos(x[:, 0]) + (10 / 3) * np.cos(10 * x[:, 0] / 3))[:, None]
    else:
        n = 12
        x = np.random.default_rng(0).uniform(-2, 2, (n, d))
        f, g = rosenbrock(x)
    lb, ub = np.full(d, -4.0), np.full(d, 2.0)
    out = []
    for pkg, cond, mod, arr in (
            (jgp, jcond, jnuts, jnp.asarray),
            (tgp, tcond, nuts, lambda a: torch.as_tensor(a, dtype=F64))):
        cfg = pkg.GpConfig(dim=d, use_grad=True, kernel_type="SqExp",
                           wellcond_mtd="precon",
                           cond_max_target=cond_max_target)
        spec = pkg.make_data_spec(d, True, n, std_fval=np.zeros(n),
                                  std_grad=np.zeros((n, d)))
        data = pkg.GpData(x=arr(x), fval=arr(f), std_fval=arr(np.zeros(n)),
                          grad=arr(g), std_grad=arr(np.zeros((n, d))))
        eta = cond.calc_etaK(cfg, n)
        logpost, z_to_hp, _ = mod.make_gp_logpost(
            cfg, spec, pkg.HpInfo(dim=d), data, eta, lb, ub)
        out.append((logpost, z_to_hp))

    def cond_of(hp_vec):      # cfg, spec, data, eta: the loop's last, the port's
        return tlkd.calc_lkd_hp_vec(cfg, spec, tgp.HpInfo(dim=d), data,
                                    hp_vec, eta, calc_cond=True).cond.numpy()
    return out[0], out[1], cond_of


# ---------------------------------------------------------------------------
# Replays of the JAX package's key-split sequences
# ---------------------------------------------------------------------------

_split = jax.jit(jax.vmap(lambda k, m: jax.random.split(k, m),
                          in_axes=(0, None)), static_argnums=1)
_uniform = jax.jit(jax.vmap(lambda k: jax.random.uniform(k)))
_bernoulli = jax.jit(jax.vmap(lambda k: jax.random.bernoulli(k)))
_normal = jax.jit(jax.vmap(lambda k, n: jax.random.normal(k, (n,)),
                           in_axes=(0, None)), static_argnums=1)


class NutsReplay(Draws):
    """Each chain's draws from its own JAX key, split as nuts_step splits
    it: (rng, momentum, tree) per transition, (tree, direction, subtree,
    accept) per doubling, (subtree, leaf) per leaf.  A call draws for every
    chain; the keys of chains that have stopped advance unused, as nothing
    reads them before the next transition."""

    def __init__(self, keys):
        super().__init__()
        self.rng = keys

    def momentum(self, n_chains, n, dtype):
        ks = _split(self.rng, 3)
        self.rng, self.tree = ks[:, 0], ks[:, 2]
        return _t(_normal(ks[:, 1], n))

    def direction(self, n_chains):
        ks = _split(self.tree, 4)
        self.tree, self.leaf, self.acc = ks[:, 0], ks[:, 2], ks[:, 3]
        return _t(_bernoulli(ks[:, 1]))

    def leaf_uniform(self, n_chains, dtype):
        ks = _split(self.leaf, 2)
        self.leaf = ks[:, 0]
        return _t(_uniform(ks[:, 1]))

    def doubling_uniform(self, n_chains, dtype):
        return _t(_uniform(self.acc))


class AdviReplay(Draws):
    """run_advi's keys: split(key, n_steps), one eps draw per step."""

    def __init__(self, key, n_steps):
        super().__init__()
        self.keys = list(jax.random.split(key, n_steps))

    def advi_eps(self, n_mc, n, dtype):
        return _t(jax.random.normal(self.keys.pop(0), (n_mc, n)))


class SmcReplay(Draws):
    """run_smc's keys: (key, prior) first; per stage (key, resample), then
    (key, mcmc) split into one key per move, each split into (proposal,
    accept)."""

    def __init__(self, key, n_mcmc):
        super().__init__()
        self.key, self.n_mcmc = key, n_mcmc

    def smc_prior(self, prior_sample, n_particles):
        self.key, self.prior_key = jax.random.split(self.key)
        return prior_sample(self, n_particles)

    def normal(self, shape, dtype=F64):      # the prior's only draw
        return _t(jax.random.normal(self.prior_key, shape))

    def smc_resample_uniform(self, dtype):
        self.key, k_rs = jax.random.split(self.key)
        self.move_keys = None
        return _t(jax.random.uniform(k_rs))

    def smc_proposal(self, shape, dtype):
        if self.move_keys is None:
            self.key, k_m = jax.random.split(self.key)
            self.move_keys = list(jax.random.split(k_m, self.n_mcmc))
        k1, self.k2 = jax.random.split(self.move_keys.pop(0))
        return _t(jax.random.normal(k1, shape))

    def smc_accept_uniform(self, n_particles, dtype):
        return _t(jax.random.uniform(self.k2, (n_particles,)))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2])
def test_make_gp_logpost_matches_jax(d):
    """Value and z-gradient at a batch of 5 z rows, against
    vmap(value_and_grad) of the JAX log posterior; the port evaluates the
    batch in one call.  Where cond(M) <= 1e6 the MLL tolerances hold (rtol
    1e-9 value, 1e-6 gradient).  At cond ~5e9 (theta ~0.3 on the d=1
    points) the two LAPACKs' round-off, amplified by cond, sets the
    packages 5e-9 apart in the value and 3e-8 of the largest gradient
    entry apart in the gradient (ROADMAP.md Queue 3): there rtol 1e-7, and
    1e-7 of the largest gradient entry."""
    (jl, jz2hp), (tl, tz2hp), cond = gp_problem(d)
    z = np.random.default_rng(1).normal(0.0, 1.0, (5, d))
    v_j, g_j = map(np.asarray, jax.jit(jax.vmap(jax.value_and_grad(jl)))(
        jnp.asarray(z)))
    zt = _t(z).requires_grad_(True)
    v_t = tl(zt)
    g_t, = torch.autograd.grad(v_t.sum(), zt)
    assert v_t.shape == (5,)
    v_t, g_t = v_t.detach().numpy(), g_t.numpy()
    good = cond(tz2hp(_t(z))) <= 1e6
    assert good.any() and (d == 2 or not good.all())
    _close(v_t[good], v_j[good], 1e-9)
    _close(g_t[good], g_j[good], 1e-6)
    _close(v_t[~good], v_j[~good], 1e-7)
    _close(g_t[~good], g_j[~good], 0.0, atol=1e-7 * np.abs(g_j).max())
    _close(tz2hp(_t(z)), jax.vmap(jz2hp)(jnp.asarray(z)), 1e-14)


def _jax_state(logp, z0, keys, step=0.1):
    lg = jax.vmap(jax.value_and_grad(logp))
    lp, g = lg(jnp.asarray(z0))
    B, n = z0.shape
    return jnuts.NutsState(
        z=jnp.asarray(z0), logp=lp, grad=g, step=jnp.full(B, step),
        inv_mass=jnp.ones((B, n)), rng=keys, accept_prob=jnp.zeros(B),
        diverging=jnp.zeros(B, bool), n_leapfrog=jnp.zeros(B, jnp.int32))


def _port_state(logp, z0, keys, step=0.1):
    lp, g = nuts.value_and_grad(logp)(_t(z0))
    B, n = z0.shape
    return nuts.NutsState(
        z=_t(z0), logp=lp, grad=g, step=torch.full((B,), step, dtype=F64),
        inv_mass=torch.ones((B, n), dtype=F64), rng=NutsReplay(keys),
        accept_prob=torch.zeros(B, dtype=F64),
        diverging=torch.zeros(B, dtype=torch.bool),
        n_leapfrog=torch.zeros(B, dtype=torch.int64))


@pytest.mark.parametrize("target", ["gauss", "gp_d1", "gp_d1_cond1e10"])
def test_nuts_step_matches_jax_with_replayed_draws(target):
    """Transitions of 4 chains in lockstep against the vmapped JAX lanes
    with the same keys; tree sizes and divergences equal.  One on the
    Gaussian (rtol 1e-10); ten on the d=1 GP posterior at
    cond_max_target 1e6 (rtol 1e-7; the accept probability, a mean of
    exp(-delta) over energies of ~45, to 1e-7 absolute).  At the default
    1e10 the posterior sits at cond(M) ~3e9-8e9, where the two LAPACKs
    disagree by 4e-5 in the gradient from the first leaf on (ROADMAP.md
    Queue 3): z, logp and grad to 1e-4 of their largest entry, the accept
    probability to 1e-4."""
    depth, step = 5, 0.2
    z0 = np.random.default_rng(2).normal(0.0, 0.3, (4, 1))
    fields = ("z", "logp", "grad", "accept_prob")
    if target == "gauss":
        jl, tl = gauss_logp()
        n_steps, depth, step = 1, 6, 0.3
        z0 = np.random.default_rng(2).normal(0.0, 1.0, (4, 2))
        tols = {f: dict(rtol=1e-10) for f in fields}
    elif target == "gp_d1":
        (jl, _), (tl, _), _ = gp_problem(1, cond_max_target=1e6)
        n_steps = 10
        tols = {f: dict(rtol=1e-7) for f in fields[:3]}
        tols["accept_prob"] = dict(rtol=0.0, atol=1e-7)
    else:
        (jl, _), (tl, _), _ = gp_problem(1)
        n_steps = 10
        tols = {f: dict(rtol=0.0, scale=1e-4) for f in fields[:3]}
        tols["accept_prob"] = dict(rtol=0.0, atol=1e-4)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    js = _jax_state(jl, z0, keys, step)
    ts = _port_state(tl, z0, keys, step)
    jstep = jax.jit(jax.vmap(lambda s: jnuts.nuts_step(
        jax.value_and_grad(jl), s, depth)))
    tlg = nuts.value_and_grad(tl)
    for _ in range(n_steps):
        js = jstep(js)
        ts = nuts.nuts_step(tlg, ts, depth)
        np.testing.assert_array_equal(ts.n_leapfrog.numpy(),
                                      np.asarray(js.n_leapfrog))
        np.testing.assert_array_equal(ts.diverging.numpy(),
                                      np.asarray(js.diverging))
        for f, tol in tols.items():
            want = np.asarray(getattr(js, f))
            atol = tol.get("atol", tol.get("scale", 0.0) * np.abs(want).max())
            _close(getattr(ts, f), want, tol["rtol"], atol=atol)
    assert int(ts.n_leapfrog.sum()) > 4      # the trees did grow


@pytest.mark.parametrize("pooled", [False, True])
def test_run_nuts_matches_jax_with_replayed_draws(pooled):
    """Warmup (dual averaging, the Welford window, the mass set at its end)
    and sampling of 4 chains on the Gaussian, per chain and pooled over the
    chain axis, against the vmapped JAX run with the same keys: each float
    field at rtol 1e-9 with the NUTS-step test's scale-relative atol (1e-9
    of its largest entry), as round-off in 20 transitions leaves an entry
    near zero 3.4e-13 apart (2.4e-9 of itself); the tree sizes and
    divergences equal."""
    jl, tl = gauss_logp()
    z0 = np.random.default_rng(4).normal(0.0, 1.0, (4, 2))
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    kw = dict(n_warmup=30, n_samples=20, max_depth=6)
    jmean = (lambda a: jax.lax.pmean(a, "chains")) if pooled else None
    zs_j, diag_j = jax.jit(jax.vmap(lambda z, k: jnuts.run_nuts(
        jl, z, k, cross_chain_mean=jmean, **kw), axis_name="chains"))(
        jnp.asarray(z0), keys)
    zs_t, diag_t = nuts.run_nuts(
        tl, _t(z0), NutsReplay(keys),
        cross_chain_mean=nuts.chain_mean if pooled else None, **kw)
    assert zs_t.shape == (4, 20, 2)
    for got, want in [(zs_t, zs_j)] + [(diag_t[k], diag_j[k]) for k in (
            "step_size", "inv_mass", "logp", "accept_prob")]:
        want = np.asarray(want)
        _close(got, want, 1e-9, atol=1e-9 * np.abs(want).max())
    for k in ("n_leapfrog", "diverging"):
        np.testing.assert_array_equal(diag_t[k].numpy(), np.asarray(diag_j[k]))
    steps = diag_t["step_size"].numpy()
    assert (np.ptp(steps) == 0.0) == pooled


@pytest.mark.parametrize("target,rtol", [("gauss", 1e-9), ("gp_d1", 1e-6)])
def test_run_advi_matches_jax_with_replayed_eps(target, rtol):
    """50 Adam steps of the ELBO with the JAX package's eps: mu,
    log_sigma and the ELBO trace."""
    if target == "gauss":
        jl, tl = gauss_logp()
        n = 2
    else:
        (jl, _), (tl, _), _ = gp_problem(1)
        n = 1
    key = jax.random.PRNGKey(6)
    res_j = jvi.run_advi(jl, jnp.zeros(n), key, n_steps=50)
    res_t = vi.run_advi(tl, torch.zeros(n, dtype=F64), AdviReplay(key, 50),
                        n_steps=50)
    for f in ("mu", "log_sigma", "elbo_trace"):
        _close(getattr(res_t, f), getattr(res_j, f), rtol)


def test_torch_adam_takes_optax_adam_steps():
    """torch.optim.Adam (b1 0.9, b2 0.999, eps 1e-8) and optax.adam take the
    same step from the same gradients: eps after the square root of the
    bias-corrected second moment."""
    import optax
    rng = np.random.default_rng(7)
    grads = rng.normal(0.0, 1.0, (40, 3)) * np.array([1e-3, 1.0, 30.0])
    p_j = jnp.asarray(rng.normal(size=3))
    p_t = _t(np.asarray(p_j)).requires_grad_(True)
    opt_j = optax.adam(5e-2)
    st = opt_j.init(p_j)
    opt_t = torch.optim.Adam([p_t], lr=5e-2, betas=(0.9, 0.999), eps=1e-8)
    for g in grads:
        upd, st = opt_j.update(jnp.asarray(g), st)
        p_j = optax.apply_updates(p_j, upd)
        p_t.grad = _t(g)
        opt_t.step()
    _close(p_t.detach(), p_j, 1e-13)


def test_run_smc_matches_jax_with_replayed_draws():
    """64 particles, 5 stages, 2 moves on the Gaussian with the JAX keys:
    particles, log weights and the ESS trace; the run resamples."""
    jl, tl = gauss_logp()
    key = jax.random.PRNGKey(8)
    kw = dict(n_particles=64, n_stages=5, n_mcmc=2)
    res_j = jsmc.run_smc(jl, lambda k, n: 3.0 * jax.random.normal(k, (n, 2)),
                         key, **kw)
    res_t = smc.run_smc(tl, lambda d, n: 3.0 * d.normal((n, 2), F64),
                        SmcReplay(key, 2), **kw)
    assert float(res_t.ess_trace.min()) < 0.5          # resampled
    for f in ("particles", "log_weights", "ess_trace", "betas"):
        _close(getattr(res_t, f), getattr(res_j, f), 1e-9, atol=1e-300)


def test_systematic_resample_matches_jax():
    """The indices of JAX's resampler, given the uniform its key draws
    (left-side search); where the cumulative sum rounds below 1 the index
    past the end is clamped to the last particle, as JAX's gather clamps
    it."""
    log_w = np.random.default_rng(9).normal(0.0, 3.0, 50)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jsmc._systematic_resample(key, jnp.asarray(log_w), 50)
        got = smc._systematic_resample(_t(jax.random.uniform(key)),
                                       _t(log_w), 50)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ten equal weights: their cumulative sum ends at 1 - 1.1e-16
    flat = torch.zeros(10, dtype=F64)
    assert float(torch.cumsum(torch.softmax(flat, 0), 0)[-1]) < 1.0
    idx = smc._systematic_resample(torch.tensor(1.0 - 2 ** -53, dtype=F64),
                                   flat, 10)
    assert int(idx[-1]) == 9


def test_diagnostics_match_jax():
    rhat_j = jax.jit(jdiag.split_rhat)
    ess_j = jax.jit(jdiag.effective_sample_size, static_argnums=1)
    rng = np.random.default_rng(10)
    for shape in ((4, 200, 3), (3, 51, 1)):
        s = rng.normal(size=shape).cumsum(1) * 0.1 + rng.normal(size=shape)
        _close(diagnostics.split_rhat(_t(s)), rhat_j(jnp.asarray(s)), 1e-12)
        for lag in (100, 7):
            _close(diagnostics.effective_sample_size(_t(s), lag),
                   ess_j(jnp.asarray(s), lag), 1e-12)


class ChainZeroLog(Draws):
    """The port's default streams, logging every draw that chain 0
    consumes (momentum each transition; a direction, a doubling uniform
    and leaf uniforms where its mask holds it)."""

    def __init__(self, seed):
        super().__init__(seed)
        self.log = []

    def momentum(self, n_chains, n, dtype):
        v = super().momentum(n_chains, n, dtype)
        self.log.append(v[0])
        return v

    def _logged(self, v, mask):
        if mask[0]:
            self.log.append(v[:1].to(torch.float64))
        return v

    def direction(self, active):
        return self._logged(super().direction(active), active)

    def leaf_uniform(self, live, dtype):
        return self._logged(super().leaf_uniform(live, dtype), live)

    def doubling_uniform(self, active, dtype):
        return self._logged(super().doubling_uniform(active, dtype), active)


def _chain_logp(z):
    """The correlated Gaussian, entry by entry: a row's value does not
    depend on the other rows of the batch."""
    return -0.5 * (PREC[0, 0] * z[:, 0] ** 2 + 2 * PREC[0, 1] * z[:, 0]
                   * z[:, 1] + PREC[1, 1] * z[:, 1] ** 2)


def test_nuts_chain_does_not_depend_on_the_other_chains():
    """Two chains with per-chain adaptation; only chain 1's start changes
    (near the mode, then far out in the tail, where its trees differ).
    Chain 0's samples, diagnostics and consumed draws stay bitwise the
    same, as each JAX lane's do with its own key.  With one stream shared
    by the chains, the lockstep group's leaf count (its longest tree) set
    how many draws chain 0 skipped."""
    kw = dict(n_warmup=30, n_samples=30, max_depth=6)
    starts = ([0.5, -0.3], [6.0, -5.0])

    def run(draws_cls):
        out = []
        for z1 in starts:
            d = draws_cls(7)
            out.append((*nuts.run_nuts(_chain_logp, _t([[0.2, 0.1], z1]), d,
                                       **kw), d))
        return out

    (zs_a, diag_a, _), (zs_b, diag_b, _) = run(Draws)
    assert not torch.equal(zs_a[1], zs_b[1])
    assert not torch.equal(diag_a["n_leapfrog"][1], diag_b["n_leapfrog"][1])
    assert torch.equal(zs_a[0], zs_b[0])
    for k in diag_a:
        assert torch.equal(diag_a[k][0], diag_b[k][0]), k
    (zs_c, _, log_a), (_, _, log_b) = run(ChainZeroLog)
    assert torch.equal(zs_c, zs_a)
    assert len(log_a.log) == len(log_b.log)
    assert all(torch.equal(a, b) for a, b in zip(log_a.log, log_b.log))

    jl, _ = gauss_logp()
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    run = jax.jit(jax.vmap(lambda z, k: jnuts.run_nuts(jl, z, k, **kw)))
    (zj_a, dj_a), (zj_b, dj_b) = (run(jnp.asarray([[0.2, 0.1], z1]), keys)
                                  for z1 in starts)
    assert not np.array_equal(zj_a[1], zj_b[1])
    np.testing.assert_array_equal(zj_a[0], zj_b[0])
    for k in dj_a:
        np.testing.assert_array_equal(dj_a[k][0], dj_b[k][0])


# ---------------------------------------------------------------------------
# Chain state carried across packages
# ---------------------------------------------------------------------------

def test_port_resumes_a_jax_chain_state(tmp_path):
    """An npz written by the JAX package's save_chain_state is read by the
    port (z, logp, grad, step, inv_mass); its JAX keys are not usable, so
    the draws keep the explicitly seeded stream they were given.  The
    port's own file carries its generator state: a resumed run repeats the
    original one."""
    jl, tl = gauss_logp()
    z0 = np.random.default_rng(11).normal(0.0, 1.0, (4, 2))
    keys = jax.random.split(jax.random.PRNGKey(12), 4)
    js = _jax_state(jl, z0, keys, 0.4)
    path = str(tmp_path / "jax_chains.npz")
    jnuts.save_chain_state(path, js._replace(
        inv_mass=jnp.asarray(np.array([1.0, 2.0]))[None].repeat(4, 0)))
    ts = nuts.load_chain_state(path, Draws(13))
    _close(ts.z, js.z, 0.0)
    _close(ts.logp, js.logp, 0.0)
    _close(ts.grad, js.grad, 0.0)
    _close(ts.step, np.full(4, 0.4), 0.0)
    _close(ts.inv_mass[:, 1], np.full(4, 2.0), 0.0)
    ref = Draws(13)
    np.testing.assert_array_equal(ts.rng.get_state(), ref.get_state())

    lg = nuts.value_and_grad(tl)
    ts = nuts.nuts_step(lg, ts, 6)
    assert torch.isfinite(ts.z).all() and int(ts.n_leapfrog.min()) >= 1
    own = str(tmp_path / "port_chains.npz")
    nuts.save_chain_state(own, ts)
    nxt = nuts.nuts_step(lg, ts, 6)
    again = nuts.nuts_step(lg, nuts.load_chain_state(own, Draws(99)), 6)
    _close(again.z, nxt.z, 0.0)


def test_nuts_checkpointed_resume(tmp_path):
    """Segmented NUTS with a checkpoint: a resumed run continues from the
    stored chain states (no warmup) and gives valid samples
    (tests/test_inference.py:159-177)."""
    _, tl = gauss_logp()
    d = Draws(0)
    z0 = d.normal((4, 2), F64)
    ckpt = str(tmp_path / "chains.npz")
    zs1, _ = nuts.run_nuts_checkpointed(tl, z0, d, ckpt, n_warmup=100,
                                        n_samples=60, segment=30,
                                        max_depth=6)
    assert zs1.shape == (4, 60, 2)
    zs2, _ = nuts.run_nuts_checkpointed(tl, z0, Draws(1), ckpt,
                                        n_warmup=100, n_samples=30,
                                        segment=30, max_depth=6, resume=True)
    assert zs2.shape == (4, 30, 2)
    s = np.concatenate([zs1, zs2], axis=1).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.4)


# ---------------------------------------------------------------------------
# The JAX tests' statistical criteria on the port's generator
# ---------------------------------------------------------------------------

def test_nuts_recovers_gaussian():
    _, tl = gauss_logp()
    d = Draws(0)
    z0 = d.normal((8, 2), F64)
    zs, diag = nuts.run_nuts(tl, z0, d, n_warmup=300, n_samples=500,
                             max_depth=6)
    s = zs.reshape(-1, 2).numpy()
    np.testing.assert_allclose(s.mean(0), [0, 0], atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), COV, atol=0.25)
    assert float(diag["diverging"].double().mean()) < 0.01
    assert 0.6 < float(diag["accept_prob"].mean()) <= 1.0


def test_nuts_f32_state_f64_logp():
    """f32 chain state over a log-density that returns f64: the tree's
    bookkeeping stays in the state dtype."""
    def logp(z):
        return -0.5 * (z.double() ** 2).sum(-1)

    zs, diag = nuts.run_nuts(logp, torch.zeros(3, dtype=torch.float32),
                             Draws(0), n_warmup=32, n_samples=32, max_depth=4)
    assert zs.dtype == torch.float32 and zs.shape == (32, 3)
    assert torch.isfinite(zs).all()
    assert float(diag["diverging"].double().mean()) < 0.5


def _gp_posterior_concentrates(n_warmup, n_samples, max_depth):
    _, (tl, z_to_hp), _ = gp_problem(1)
    n = 8
    x = np.linspace(2.5, 7.5, n)[:, None]
    f = np.sin(x[:, 0]) + np.sin(10 * x[:, 0] / 3)
    g = (np.cos(x[:, 0]) + (10 / 3) * np.cos(10 * x[:, 0] / 3))[:, None]
    cfg = tgp.GpConfig(dim=1, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon")
    spec = tgp.make_data_spec(1, True, n, std_fval=np.zeros(n),
                              std_grad=np.zeros((n, 1)))
    data = tgp.GpData(*(torch.as_tensor(a, dtype=F64) for a in (
        x, f, np.zeros(n), g, np.zeros((n, 1)))))
    fit = multistart.fit_map(cfg, spec, tgp.HpInfo(dim=1), data,
                             tcond.calc_etaK(cfg, n))
    zs, diag = nuts.run_nuts(tl, torch.zeros((4, 1), dtype=F64), Draws(2),
                             n_warmup=n_warmup, n_samples=n_samples,
                             max_depth=max_depth)
    hp = z_to_hp(zs).reshape(-1).numpy()
    assert abs(np.median(hp) - float(fit.hp_vec[0])) < 0.5
    assert float(diag["diverging"].double().mean()) < 0.05


def test_nuts_gp_hyperparameter_posterior():
    """The posterior over log10(theta) of the d=1 GP concentrates around
    the port's MAP estimate.  Cut from the JAX test's 200 + 300 transitions
    at depth 8 to 30 + 30 at depth 5: the posterior takes ~40 leapfrogs per
    transition at ~4 ms each on one CPU core (a test worker's share of the
    cores, conftest.py; all 8 cores are no faster), and the median
    sits within 0.04 of the MAP (limit 0.5) at this size on seeds 0-2.  The
    JAX length runs in test_nuts_gp_hyperparameter_posterior_jax_length."""
    _gp_posterior_concentrates(30, 30, 5)


@pytest.mark.slow
def test_nuts_gp_hyperparameter_posterior_jax_length():
    """The same criterion at the JAX test's length: 200 + 300 transitions
    at depth 8 (tests/test_inference.py:59-93)."""
    _gp_posterior_concentrates(200, 300, 8)


def test_advi_gaussian():
    """The JAX test's criteria on the mean-field optimum (mu within 0.1,
    variances within rtol 0.25).  Adam's last iterate is noisy: over 20
    seeds a single run misses the mu criterion 5 times in the JAX package
    and 4 in the port, the variance criterion once and 5 times, with the
    same spread (std 0.05-0.08 in mu, 0.14-0.16 in the variance ratio).
    So both are averaged over seeds 0-3."""
    _, tl = gauss_logp()
    mu, var = [], []
    for seed in range(4):
        res = vi.run_advi(tl, torch.zeros(2, dtype=F64), Draws(seed),
                          n_steps=1500, learning_rate=3e-2)
        assert res.elbo_trace[-1] > res.elbo_trace[0]
        mu.append(res.mu.numpy())
        var.append(np.exp(2 * res.log_sigma.numpy()))
    np.testing.assert_allclose(np.mean(mu, 0), [0, 0], atol=0.1)
    # mean-field optimum for a Gaussian: variances -> 1 / diag(precision)
    np.testing.assert_allclose(np.mean(var, 0), 1.0 / np.diag(PREC),
                               rtol=0.25)
    assert vi.sample_vi(res, Draws(1), 10).shape == (10, 2)


def test_smc_gaussian():
    _, tl = gauss_logp()
    res = smc.run_smc(tl, lambda d, n: 3.0 * d.normal((n, 2), F64), Draws(0),
                      n_particles=1024, n_stages=16, n_mcmc=8, rw_scale=0.6)
    w = torch.softmax(res.log_weights, 0).numpy()
    s = res.particles.numpy()
    np.testing.assert_allclose((w[:, None] * s).sum(0), [0, 0], atol=0.25)
    np.testing.assert_allclose(np.cov(s.T, aweights=w), COV, atol=0.5)


def test_diagnostics_rhat_ess():
    rng = np.random.default_rng(0)
    good = _t(rng.standard_normal((4, 500, 2)))
    assert bool((diagnostics.split_rhat(good) < 1.05).all())
    assert bool((diagnostics.effective_sample_size(good) > 500).all())
    bad = _t(rng.standard_normal((4, 500, 1))
             + np.arange(4)[:, None, None] * 10.0)
    assert bool((diagnostics.split_rhat(bad) > 2.0).all())


def _sample_posterior_concentrates(n_warmup, n_samples, max_depth):
    n = 8
    x = np.linspace(2.5, 7.5, n)[:, None]
    f = np.sin(x[:, 0]) + np.sin(10 * x[:, 0] / 3)
    g = (np.cos(x[:, 0]) + (10 / 3) * np.cos(10 * x[:, 0] / 3))[:, None]
    gp = GaussianProcess(1, True, "SqExp", "precon", device="cpu")
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, 1)))
    gp.set_hpara("optz", 0)
    samples, diag = gp.sample_posterior(n_chains=4, n_warmup=n_warmup,
                                        n_samples=n_samples,
                                        max_depth=max_depth, seed=0)
    assert samples.shape == (4, n_samples, 1)
    assert set(diag) == {"logp", "accept_prob", "diverging", "n_leapfrog",
                         "step_size", "inv_mass"}
    assert all(isinstance(v, np.ndarray) for v in diag.values())
    theta_map = float(np.asarray(gp.hp_vals.theta)[0])
    med = float(np.median(samples[..., 0]))
    assert abs(np.log10(med) - np.log10(theta_map)) < 0.6
    assert float(np.mean(diag["diverging"])) < 0.05


def test_sample_posterior_concentrates():
    """The facade on the CPU (tests/test_api_extras.py:22-31), cut from
    150 + 200 transitions at depth 6 to 30 + 30 at depth 5 (see
    test_nuts_gp_hyperparameter_posterior); the JAX length runs in
    test_sample_posterior_concentrates_jax_length."""
    _sample_posterior_concentrates(30, 30, 5)


@pytest.mark.slow
def test_sample_posterior_concentrates_jax_length():
    """The same criterion at the JAX test's length: 150 + 200 transitions
    at depth 6."""
    _sample_posterior_concentrates(150, 200, 6)
