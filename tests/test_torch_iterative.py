"""Parity of the port's matrix-free iterative solver (solver='iterative')
with the JAX package, in float64 on the CPU: the row-tiled matvec and its
theta gradient (the plain version, and ``KernMatvecFn``, whose K1/K2 calls
take their plain versions on CPU tensors), mBCG, SLQ with the JAX
package's probes, the CG/SLQ likelihood and its determinant-free gradients
in both noise regimes, the closed form, the iterative predict, the fit
driver, and the facade (predict, fit, rescaling frame, make_predict_fn,
refusals).

The functions are held to the JAX package's at cond_max_target 1e2, where
CG converges in 40-80 iterations on these 60-row systems and both packages
take the same number; at 1e4 it takes over 100 (more than the rows, as
round-off erodes the Krylov basis) and the last residuals, a few 1e-11
apart in the two packages' sums, decide the count to within one or two.
The facade tests run at 1e4, and the iterative-vs-dense fit at 1e3 and
n_eval=16 (the JAX test's 1e6 and n_eval=40 take minutes here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpgradpy_tpu as jgp
from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_tpu.fit import iterative_driver as jdrv
from gpgradpy_tpu.model import conditioning as jcond
from gpgradpy_tpu.model import likelihood_iter as jli
from gpgradpy_tpu.model import predict_iter as jpi
from gpgradpy_tpu.ops import iterative as jops
import gpgradpy_torch as tgp
from gpgradpy_torch import GaussianProcess, convert
from gpgradpy_torch.fit import iterative_driver as tdrv
from gpgradpy_torch.model import likelihood_iter as tli
from gpgradpy_torch.model import predict_iter as tpi
from gpgradpy_torch.ops import iterative as tops

COND = dict(cond_max_target=1e4, cond_max=1e4)
KW = dict(max_cg_iters=128, cg_tol=1e-10, row_block=16)
N_PROBES = 8
THETA = np.array([3.0, 2.0])


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def iproblem(noise=None, grads="full", n=20, dim=2, wellcond="precon",
             ktype="SqExp", seed=0, cond=1e2):
    """The same numpy data as the inputs of both packages: cfg, spec and
    data of each ('j' JAX, 't' torch), the nugget and the JAX probes."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, dim))
    f = np.sum(x ** 2, 1) + 0.3 * np.sin(3 * x[:, 0])
    g = 2 * x
    g[:, 0] += 0.9 * np.cos(3 * x[:, 0])
    s = 0.05 if noise == "known" else 0.0
    std_f, std_g = np.full(n, s), np.full((n, dim), s)
    bvec = None
    if grads == "partial":
        bvec = np.arange(n) % 3 != 1
        g, std_g = g[bvec], std_g[bvec]
    use_grad = grads != "none"
    if not use_grad:
        g = std_g = None
    out = {}
    for key, pkg, arr in (("j", jgp, jnp.asarray), ("t", tgp, t64)):
        cfg = pkg.GpConfig(dim=dim, use_grad=use_grad, kernel_type=ktype,
                           wellcond_mtd=wellcond, cond_max_target=cond,
                           cond_max=cond)
        spec = pkg.make_data_spec(dim, use_grad, n, std_fval=std_f,
                                  std_grad=std_g, bvec_use_grad=bvec)
        data = pkg.GpData(x=arr(x), fval=arr(f), std_fval=arr(std_f),
                          grad=None if g is None else arr(g),
                          std_grad=None if std_g is None else arr(std_g))
        out[key] = dict(cfg=cfg, spec=spec, data=data)
    out["eta"] = jcond.calc_etaK(out["j"]["cfg"], n)
    out["key"] = jax.random.PRNGKey(0)
    # the probes calc_lkd_iterative draws from its key (likelihood_iter.py:229)
    z = jax.random.rademacher(jax.random.split(out["key"], 1)[0],
                              (n * (1 + dim), N_PROBES), dtype=jnp.float64)
    out["z"] = np.asarray(z)
    return out


def hypers(p, theta=THETA, varK=None):
    hj = jgp.Hypers(theta=jnp.asarray(theta),
                    varK=None if varK is None else jnp.asarray(varK))
    ht = convert.hypers_from_numpy(dict(theta=theta, varK=varK),
                                   device="cpu")
    return hj, ht


def _matvec_inputs(ktype, n=37, d=3, m=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    theta = rng.uniform(0.3, 1.5, d)
    alpha = 1.7 if ktype == "RatQu" else None
    N = n * (1 + d)
    return (x, theta, alpha, rng.standard_normal((N, m)),
            rng.uniform(0.1, 0.5, N), rng.uniform(0.5, 2.0, N),
            rng.standard_normal((N, m)))


@pytest.mark.parametrize("ktype", ["SqExp", "Ma5f2", "RatQu"])
def test_kern_matvec_matches_jax(ktype):
    """n=37 points in tiles of 16 (ragged last tile), noise and eta P^2
    extras: the plain version and KernMatvecFn (tiling, scatter) against
    the JAX package's matvec to 1e-12 of max|Kv|; the port takes eta P^2
    folded into its diagonal, as _iter_setup's matvec passes it."""
    x, th, al, V, nv, pv, _ = _matvec_inputs(ktype)
    want = np.asarray(jops.kern_matvec(
        ktype, jnp.asarray(x), jnp.asarray(th), al, jnp.asarray(V),
        row_block=16, noise_over_varK=jnp.asarray(nv), eta=1e-3,
        pvec=jnp.asarray(pv)))
    at = None if al is None else t64(al)
    got = tops.kern_matvec(ktype, t64(x), t64(th), at, t64(V), row_block=16,
                           noise_over_varK=t64(nv + 1e-3 * pv ** 2))
    scale = np.max(np.abs(want))
    close(got, want, rtol=0, atol=1e-12 * scale)
    want_K = np.asarray(jops.kern_matvec(ktype, jnp.asarray(x),
                                         jnp.asarray(th), al,
                                         jnp.asarray(V[:, 0]), row_block=16))
    for rb in (16, 64):      # ragged tiles, then one tile of all points
        fn = tops.KernMatvecFn.apply(ktype, rb, t64(x), t64(th), at, t64(V))
        close(fn[:, 0], want_K, rtol=0, atol=1e-12 * np.max(np.abs(want_K)))
    close(tops.kern_matvec(ktype, t64(x), t64(th), at, t64(V[:, 0]),
                           row_block=16), want_K, rtol=0,
          atol=1e-12 * np.max(np.abs(want_K)))


@pytest.mark.parametrize("ktype", ["SqExp", "Ma5f2", "RatQu"])
def test_matvec_gradients_match_jax(ktype):
    """d/dtheta of a^T K(theta) V b: autograd of the plain version and
    KernMatvecFn's backward (K2 per tile) against jax.grad (rtol 1e-10);
    KernMatvecFn's V-cotangent (one more matvec, K symmetric) against
    autograd of the plain version."""
    x, th, al, V, _, _, Gout = _matvec_inputs(ktype)

    def f_jax(theta):
        return jnp.sum(jnp.asarray(Gout) * jops.kern_matvec(
            ktype, jnp.asarray(x), theta, al, jnp.asarray(V), row_block=16))
    want = np.asarray(jax.grad(f_jax)(jnp.asarray(th)))
    at = None if al is None else t64(al)

    def grads(fn):
        t = t64(th).requires_grad_(True)
        v = t64(V).requires_grad_(True)
        return torch.autograd.grad((t64(Gout) * fn(t, v)).sum(), (t, v))

    g_t, g_v_plain = grads(lambda t, v: tops.kern_matvec_plain(
        ktype, t64(x), t, at, v, 16))
    close(g_t, want, rtol=1e-10)
    g_t, g_v = grads(lambda t, v: tops.KernMatvecFn.apply(
        ktype, 16, t64(x), t, at, v))
    close(g_t, want, rtol=1e-10)
    close(g_v, g_v_plain, rtol=0, atol=1e-12 * float(g_v_plain.abs().max()))
    with pytest.raises(NotImplementedError):
        xt = t64(x).requires_grad_(True)
        tops.KernMatvecFn.apply(ktype, 16, xt, t64(th), at,
                                t64(V)).sum().backward()


@pytest.mark.parametrize("grads,noise", [("partial", "known"),
                                         ("none", None)])
def test_masked_matvec_matches_jax(grads, noise):
    """The masked full layout (partial / no gradients) with the noise and
    eta extras: _iter_setup's matvec and diagonal against the JAX
    package's (1e-12)."""
    p = iproblem(noise, grads, n=23,
                 wellcond="precon" if grads != "none" else "base")
    varK = 2.0 if noise else None
    hj, ht = hypers(p, varK=varK)
    V = np.random.default_rng(3).standard_normal((23 * 3, 4))
    pj = jli._iter_setup(p["j"]["cfg"], p["j"]["spec"], p["j"]["data"],
                         p["eta"], 16)
    pt = tli._iter_setup(p["t"]["cfg"], p["t"]["spec"], p["t"]["data"],
                         p["eta"], 16)
    want = np.asarray(pj.mv_hp(hj, jnp.asarray(V)))
    close(pt.mv_hp(ht, t64(V)), want, rtol=0,
          atol=1e-12 * np.max(np.abs(want)))
    close(pt.diag_hp(ht), pj.diag_hp(hj), rtol=1e-14)
    close(pt.data_vec, pj.data_vec, rtol=0)
    close(pt.vand, pj.vand, rtol=0)


def _solver_pair(p, hj, ht):
    pj = jli._iter_setup(p["j"]["cfg"], p["j"]["spec"], p["j"]["data"],
                         p["eta"], 16)
    pt = tli._iter_setup(p["t"]["cfg"], p["t"]["spec"], p["t"]["data"],
                         p["eta"], 16)
    return pj, pt


@pytest.mark.parametrize("check_every", [1, 8])
def test_mbcg_matches_jax(check_every):
    """Batched preconditioned CG on the scaled system, 4 right-hand sides:
    X to rtol 1e-8, the iteration count, and the Lanczos coefficients
    (rtol 1e-8, first 16 steps), whichever iteration the host reads the
    convergence flags at."""
    p = iproblem()
    hj, ht = hypers(p)
    pj, pt = _solver_pair(p, hj, ht)
    B = np.random.default_rng(4).standard_normal((60, 4))
    dj = 1.0 / pj.diag_hp(hj)
    want = jax.jit(lambda b: jops.mbcg(lambda V: pj.mv_hp(hj, V), b,
                                       max_iters=128, tol=1e-10,
                                       M_inv_diag=dj))(jnp.asarray(B))
    got = tops.mbcg(lambda V: pt.mv_hp(ht, V), t64(B), max_iters=128,
                    tol=1e-10, M_inv_diag=1.0 / pt.diag_hp(ht),
                    check_every=check_every)
    k = int(got.n_iter)
    assert k == int(want.n_iter) < 128
    close(got.X, want.X, rtol=1e-8, atol=1e-8 * np.max(np.abs(want.X)))
    # the first 16 steps, before round-off has eroded the Krylov basis
    # (later steps run on it and differ in the two packages' sums)
    for got_c, want_c in ((got.alphas, want.alphas), (got.betas, want.betas)):
        close(got_c[:16], want_c[:16], rtol=1e-8)
    assert got.alphas[k - 1].any() and not got.alphas[k:].any()
    assert float(got.residnorm.max()) < 1e-10


def test_slq_logdet_matches_jax():
    """SLQ with the JAX package's probes, on the scaled system: the port
    builds T only up to the iterations CG ran (rtol 1e-8)."""
    p = iproblem()
    hj, ht = hypers(p)
    pj, pt = _solver_pair(p, hj, ht)
    want, res_j = jax.jit(lambda: jops.slq_logdet(
        lambda V: pj.mv_hp(hj, V), 60, jax.random.split(p["key"], 1)[0],
        n_probes=N_PROBES, max_iters=128, scale_diag=pj.diag_hp(hj)))()
    got, res_t = tops.slq_logdet(lambda V: pt.mv_hp(ht, V), t64(p["z"]),
                                 max_iters=128, scale_diag=pt.diag_hp(ht))
    assert int(res_t.n_iter) == int(res_j.n_iter)
    close(got, want, rtol=1e-8)


LKD_CASES = [(None, "full", "precon"), (None, "full", "base"),
             ("known", "full", "precon"), (None, "partial", "precon"),
             (None, "none", "base")]


def _lkd_pair(noise, grads, wellcond, fn_j, fn_t):
    p = iproblem(noise, grads, wellcond=wellcond)
    hj, ht = hypers(p, varK=2.0 if noise else None)
    j, t = p["j"], p["t"]
    want = jax.jit(lambda hp: fn_j(j["cfg"], j["spec"], j["data"], hp,
                                   p["eta"], p["key"], n_probes=N_PROBES,
                                   **KW))(hj)
    got = fn_t(t["cfg"], t["spec"], t["data"], ht, p["eta"], t64(p["z"]),
               **KW)
    return got, want


@pytest.mark.parametrize("noise,grads,wellcond", LKD_CASES)
def test_calc_lkd_iterative_matches_jax(noise, grads, wellcond):
    """ln L, beta and varK of the CG/SLQ likelihood (rtol 1e-8), noise-free
    and noisy, 'precon' and 'base', full, partial and no gradients."""
    fj, ft = ((jli.calc_lkd_iterative_noisy, tli.calc_lkd_iterative_noisy)
              if noise else (jli.calc_lkd_iterative, tli.calc_lkd_iterative))
    got, want = _lkd_pair(noise, grads, wellcond, fj, ft)
    for name in ("ln_lkd", "beta", "varK", "ln_det"):
        close(getattr(got, name), getattr(want, name), rtol=1e-8)
    assert int(got.cg_iters) == int(want.cg_iters)


@pytest.mark.parametrize("noise", [None, "known"])
def test_neg_mll_and_grad_match_jax(noise):
    """-ln L (rtol 1e-8) and its determinant-free gradient (rtol 1e-6): in
    theta noise-free, in theta and varK noisy."""
    fj, ft = ((jli.neg_mll_iterative_noisy_and_grad,
               tli.neg_mll_iterative_noisy_and_grad) if noise else
              (jli.neg_mll_iterative_and_grad, tli.neg_mll_iterative_and_grad))
    got, want = _lkd_pair(noise, "full", "precon", fj, ft)
    close(got[0], want[0], rtol=1e-8)
    if noise:
        close(got[1].theta, want[1].theta, rtol=1e-6)
        close(got[1].varK, want[1].varK, rtol=1e-6)
    else:
        close(got[1], want[1], rtol=1e-6)


@pytest.mark.parametrize("grads,noise", [("full", None), ("partial", None),
                                         ("full", "known")])
def test_closed_form_and_predict_match_jax(grads, noise):
    """closed_form_iterative (rtol 1e-8), setup_eval_iterative,
    eval_model_iterative and predict_iterative against the JAX package,
    to the tolerances of the JAX facade's own iterative-vs-dense test."""
    p = iproblem(noise, grads, cond=1e4)
    hj, ht = hypers(p, varK=2.0 if noise else None)
    j, t, eta = p["j"], p["t"], p["eta"]
    xq = np.random.default_rng(99).uniform(-0.9, 0.9, (7, 2))
    cf_j = jli.closed_form_iterative(j["cfg"], j["spec"], j["data"], hj, eta,
                                     **KW)
    cf_t = tli.closed_form_iterative(t["cfg"], t["spec"], t["data"], ht, eta,
                                     **KW)
    close(cf_t.beta, cf_j.beta, rtol=1e-8)
    close(cf_t.varK, cf_j.varK, rtol=1e-8)
    st_j = jpi.setup_eval_iterative(j["cfg"], j["spec"], j["data"], cf_j,
                                    eta, **KW)
    st_t = tpi.setup_eval_iterative(t["cfg"], t["spec"], t["data"], cf_t,
                                    eta, **KW)
    close(st_t.alpha, st_j.alpha, rtol=1e-7,
          atol=1e-9 * np.max(np.abs(st_j.alpha)))
    want = jax.jit(lambda s, q: jpi.eval_model_iterative(
        j["cfg"], j["spec"], j["data"], s, eta, q, calc_grad=True, **KW))(
            st_j, jnp.asarray(xq))
    got = tpi.eval_model_iterative(t["cfg"], t["spec"], t["data"], st_t, eta,
                                   t64(xq), calc_grad=True, **KW)
    for g, w, rtol, atol in zip(got, want, (1e-7, 1e-5, 1e-6, 1e-4),
                                (1e-9, 1e-9, 1e-7, 1e-7)):
        close(g, w, rtol=rtol, atol=atol)
    mu_j, sig_j, beta_j, varK_j, _ = jpi.predict_iterative(
        j["cfg"], j["spec"], j["data"], hj, eta, jnp.asarray(xq), **KW)
    mu_t, sig_t, beta_t, varK_t, _ = tpi.predict_iterative(
        t["cfg"], t["spec"], t["data"], ht, eta, t64(xq), **KW)
    close(mu_t, mu_j, rtol=1e-7, atol=1e-9)
    close(sig_t, sig_j, rtol=1e-5, atol=1e-9)
    close(beta_t, beta_j, rtol=1e-8)


def test_capped_cg_predict_matches_jax():
    """With the CG cap below the iterations CG needs (8 here, where it
    needs about 100), the port's predict stops where the JAX package's
    stops: the same unconverged answer (rtol 1e-10), away from the
    converged one.  Past some 16 iterations at this conditioning the two
    packages' round-off, amplified by the eroding Krylov basis, tells
    their capped answers apart; a converged answer does not depend on it."""
    p = iproblem(cond=1e3)
    hj, ht = hypers(p)
    j, t, eta = p["j"], p["t"], p["eta"]
    xq = np.random.default_rng(99).uniform(-0.9, 0.9, (7, 2))
    kw = dict(KW, max_cg_iters=8)
    st_j = jpi.setup_eval_iterative(j["cfg"], j["spec"], j["data"],
                                    jli.closed_form_iterative(
                                        j["cfg"], j["spec"], j["data"], hj,
                                        eta, **kw), eta, **kw)
    st_t = tpi.setup_eval_iterative(t["cfg"], t["spec"], t["data"],
                                    tli.closed_form_iterative(
                                        t["cfg"], t["spec"], t["data"], ht,
                                        eta, **kw), eta, **kw)
    assert float(st_t.cg_resid) > 1e-3 and int(st_t.cg_iters) == 8
    want = jpi.eval_model_iterative(j["cfg"], j["spec"], j["data"], st_j, eta,
                                    jnp.asarray(xq), calc_grad=True, **kw)
    got = tpi.eval_model_iterative(t["cfg"], t["spec"], t["data"], st_t, eta,
                                   t64(xq), calc_grad=True, **kw)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-10, atol=1e-12 * np.max(np.abs(w)))
    mu_conv = tpi.predict_iterative(t["cfg"], t["spec"], t["data"], ht, eta,
                                    t64(xq), **KW)[0]
    assert np.max(np.abs(np.asarray(got[0]) - np.asarray(mu_conv))) > 1e-6


def test_fit_map_iterative_matches_jax():
    """The fit driver from one start with the JAX package's probes (its
    key's, seed + 7 i_optz): -ln L at the optimum to rtol 1e-6.  The two
    L-BFGS runs stop on tol_f a step apart on a flat optimum, so theta is
    held to 1e-4 in log10."""
    p = iproblem(n=12, cond=1e3)
    kw = dict(solver="iterative", iter_row_block=16, iter_max_cg=128,
              iter_n_probes=N_PROBES)
    cj, ct = p["j"]["cfg"].replace(**kw), p["t"]["cfg"].replace(**kw)
    x0 = np.zeros((1, 2))
    want = jdrv.fit_map_iterative(cj, p["j"]["spec"], jgp.HpInfo(dim=2),
                                  p["j"]["data"], p["eta"], seed=1,
                                  x0_override=x0)
    z = jax.random.rademacher(jax.random.split(jax.random.PRNGKey(1), 1)[0],
                              (36, N_PROBES), dtype=jnp.float64)
    got = tdrv.fit_map_iterative(ct, p["t"]["spec"], tgp.HpInfo(dim=2),
                                 p["t"]["data"], p["eta"], seed=1,
                                 x0_override=x0, probes=np.asarray(z))
    close(got.neg_lkd, want.neg_lkd, rtol=1e-6)
    close(got.hp_vec, want.hp_vec, rtol=0, atol=1e-4)
    assert np.isnan(got.cond) and got.info["iter_cg_resid"] < 1e-10
    assert got.info["iter_cg_iters"] > 0 and got.info["optz_n_val"] > 1


def _fdata(n=20, dim=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, dim))
    f = np.sum(x ** 2, axis=1) + 0.5 * np.sin(3.0 * x[:, 0]) * x[:, 1]
    g = 2.0 * x
    g[:, 0] += 1.5 * np.cos(3.0 * x[:, 0]) * x[:, 1]
    g[:, 1] += 0.5 * np.sin(3.0 * x[:, 0])
    xq = np.random.default_rng(99).uniform(-1.4, 1.4, (7, dim))
    return x, f, g, xq


def _facade(cls, solver, wellcond="precon", n=20, cond=1e4, **kw):
    x, f, g, _ = _fdata(n)
    if cls is GaussianProcess:
        kw["device"] = "cpu"
    gp = cls(2, True, "SqExp", wellcond, solver=solver, cond_max_target=cond,
             cond_max=cond, **kw)
    gp.set_data(x, f, np.zeros(n), g, np.zeros_like(g))
    return gp


def _same_hp(gp):
    gp.set_custom_hp(theta=THETA)
    gp.set_hpara("current", 0)
    return gp


@pytest.mark.parametrize("wellcond", ["precon", "rescale_origin"])
def test_facade_iterative_predict_matches_jax(wellcond):
    """The port's iterative facade against the JAX package's at equal
    hyperparameters (in the rescaling frame too): eval_model with
    gradients and eval_model_var, to the JAX facade test's tolerances;
    make_predict_fn returns eval_model's values (outside a frame)."""
    xq = _fdata()[3]
    gp_t = _same_hp(_facade(GaussianProcess, "iterative", wellcond))
    gp_j = _same_hp(_facade(JaxGP, "iterative", wellcond))
    assert gp_t.condK is None
    got = gp_t.eval_model(xq, calc_grad=True)
    want = gp_j.eval_model(xq, calc_grad=True)
    for g, w, rtol, atol in zip(got[:4], want[:4], (1e-7, 1e-5, 1e-6, 1e-4),
                                (1e-9, 1e-9, 1e-7, 1e-7)):
        close(g, w, rtol=rtol, atol=atol)
    assert got[4] is None and got[5] is None
    v_t = gp_t.eval_model_var(xq, calc_grad=True)
    v_j = gp_j.eval_model_var(xq, calc_grad=True)
    close(v_t[0], v_j[0], rtol=1e-5, atol=1e-12)
    close(v_t[1], v_j[1], rtol=1e-4, atol=1e-9)
    if wellcond == "precon":
        out = gp_t.make_predict_fn(calc_grad=True)(xq)
        for a, b in zip(out, got):
            assert (a is None and b is None) or np.array_equal(a.numpy(), b)
    else:
        with pytest.raises(ValueError, match="rescaling"):
            gp_t.make_predict_fn()


def test_make_predict_fn_dense():
    """The serving callable of the dense solver returns eval_model's values,
    Hessians included."""
    xq = _fdata()[3]
    gp = _same_hp(_facade(GaussianProcess, "dense"))
    want = gp.eval_model(xq, calc_grad=True, calc_hess=True)
    got = gp.make_predict_fn(calc_grad=True, calc_hess=True)(xq)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert gp.make_predict_fn()(torch.as_tensor(xq[0]))[0].shape == (1,)


def test_facade_iterative_fit_reaches_dense_quality():
    """optz_hp through the CG/SLQ likelihood: the dense -ln L at the
    iterative fit's hyperparameters is within the JAX test's margin,
    max(2, 0.02 |f|), of the dense optimum."""
    gpd = _facade(GaussianProcess, "dense", n=16, cond=1e3)
    gpi = _facade(GaussianProcess, "iterative", n=16, cond=1e3)
    for gp in (gpd, gpi):
        gp.init_optz_surr(2)
        gp.set_hpara("optz", 0)
    f_d = -float(gpd.calc_lkd_all(gpd.hp_vals)[0].ln_lkd)
    f_i = -float(gpd.calc_lkd_all(gpi.hp_vals)[0].ln_lkd)
    assert np.isfinite(f_i) and f_i <= f_d + max(2.0, 0.02 * abs(f_d))
    assert np.isnan(gpi.history.Kcov_cond[0])
    assert gpi.optz_infos[0]["iter_cg_resid"] < 1e-10


def test_rescale_loop_fits_through_the_iterative_driver():
    """The rescale fixed-point loop runs its inner fits through the
    iterative driver (short fits: the loop, not the optimum, is checked)."""
    gpr = _facade(GaussianProcess, "iterative", "rescale_origin", n=8,
                  optz_iter_max=3)
    gpr.init_optz_surr(2)
    gpr.set_hpara("optz", 0)
    assert len(gpr.optz_infos) >= 1
    assert np.all(np.isfinite(gpr.history.xvec_rescaling[0]))
    assert np.all(np.isfinite(gpr.eval_model(_fdata()[3])[0]))


def test_iterative_refusals():
    """What the iterative solver does not run raises with the JAX package's
    message: a fitted RatQu alpha, Hessians, and polish; padding is not
    applied.  (The sharded matvec, iter_use_mesh, runs: test_torch_parallel.py.)"""
    with pytest.raises(AssertionError, match="polish_cond_target"):
        GaussianProcess(2, True, solver="iterative", polish_cond_target=1e10,
                        device="cpu")
    x, f, g, xq = _fdata(8)
    gp = GaussianProcess(2, True, "RatQu", solver="iterative", device="cpu",
                         pad_n_eval_multiple=16, **COND)
    gp.set_data(x, f, np.zeros(8), g, np.zeros_like(g))
    assert gp.spec.n_pad_eval == 0
    gp.init_optz_surr(2)
    with pytest.raises(NotImplementedError, match="RatQu alpha"):
        gp.set_hpara("optz", 0)
    gp.set_custom_hp(theta=THETA, kernel=2.0)
    gp.set_hpara("current", 0)
    with pytest.raises(NotImplementedError, match="Hessians"):
        gp.eval_model(xq, calc_grad=True, calc_hess=True)
    with pytest.raises(NotImplementedError, match="Hessians"):
        gp.eval_model_var(xq, calc_grad=True, calc_hess=True)
    assert np.all(np.isfinite(gp.eval_model(xq)[1]))


def test_probes_are_seeded_on_the_cpu():
    """The port's own probes: Rademacher, a function of the seed alone."""
    a = tops.rademacher(30, 4, 8, torch.float64)
    assert torch.equal(a, tops.rademacher(30, 4, 8, torch.float64))
    assert set(a.unique().tolist()) == {-1.0, 1.0}
    assert not torch.equal(a, tops.rademacher(30, 4, 15, torch.float64))


# the theta of the iterative fit at d=10 / n_eval=200 on the H100 (PERF.md,
# section 6), where the port's predict at the default CG cap stood 536 times
# the JAX test's mu tolerance from the dense one
D10_THETA = [0.027093557373919882, 0.027530130887621563, 0.02778187069296766,
             0.030307737839111188, 0.028773219110307478, 0.027960749037072498,
             0.027408229519886425, 0.02816712579461613, 0.029777609591534502,
             0.001065027274516044]


def capped_predict_at_d10():
    """Each package's iterative predict with the default CG cap (1024)
    against its own dense predict, on chip_smoke's d=10 / n_eval=200
    Rosenbrock data at D10_THETA and cond_max_target 1e6, on the CPU (the
    port with device="cpu"): each output's max |difference| and its
    multiple of the JAX facade test's tolerances.  A few minutes; run it
    as a script:
        JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_iterative.py"""
    import time
    from gpgradpy_tpu.bo.problems import rosenbrock
    jax.config.update("jax_enable_x64", True)
    d, n = 10, 200
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    xt = rng.uniform(-2, 2, (128, d))
    for pkg, cls, kw in (("JAX package", JaxGP, {}),
                         ("port", GaussianProcess, dict(device="cpu"))):
        out = {}
        for solver in ("dense", "iterative"):
            t0 = time.perf_counter()
            gp = cls(d, True, "SqExp", "precon", solver=solver,
                     cond_max_target=1e6, cond_max=1e6, **kw)
            gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
            gp.set_custom_hp(theta=np.asarray(D10_THETA))
            gp.set_hpara("current", 0)
            out[solver] = [np.asarray(a) for a in
                           gp.eval_model(xt, calc_grad=True)[:4]]
            print(f"{pkg} {solver}: {time.perf_counter() - t0:.1f} s")
        for name, a, b, (rtol, atol) in zip(
                ("mu", "sig", "dmu", "dsig"), out["iterative"], out["dense"],
                ((1e-7, 1e-9), (1e-5, 1e-9), (1e-6, 1e-7), (1e-4, 1e-7))):
            excess = np.max(np.abs(a - b) / (atol + rtol * np.abs(b)))
            print(f"{pkg} {name}: max|d| {np.max(np.abs(a - b)):.3e}, "
                  f"{excess:.2f} times rtol {rtol:.0e} atol {atol:.0e}")


if __name__ == "__main__":
    capped_predict_at_d10()
