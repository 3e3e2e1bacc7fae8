"""Parity of the port's covariance assembly and marginal likelihood with the
JAX package, in float64 on the CPU: assemble_keta (nugget, log-det,
padding), calc_lkd in both noise regimes, neg_mll_and_grad at the same
hyperparameter vector, and the per-row failed-Cholesky fallback of a
batched evaluation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpgradpy_tpu as jgp
from gpgradpy_tpu.model import assembly as jassembly
from gpgradpy_tpu.model import conditioning as jcond
from gpgradpy_tpu.model import likelihood as jlkd
import gpgradpy_torch as tgp
from gpgradpy_torch.model import assembly as tassembly
from gpgradpy_torch.model import conditioning as tcond
from gpgradpy_torch.model import likelihood as tlkd

KERNELS = ["SqExp", "Ma5f2", "RatQu"]


def problem(ktype="SqExp", noise=None, n=8, dim=2, seed=0, n_pad=0,
            wellcond="precon", partial=False):
    """The same numpy data as the inputs of both packages: a dict with
    cfg, spec, data and info of each ('j' JAX, 't' torch) and the nugget."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, dim))
    f = np.sum(x ** 2, 1) + 0.3 * np.sin(3 * x[:, 0])
    g = 2 * x
    g[:, 0] += 0.9 * np.cos(3 * x[:, 0])
    if noise == "known":
        std_f, std_g = np.full(n, 0.05), np.full((n, dim), 0.05)
    elif noise == "unknown":
        std_f = std_g = None
    else:
        std_f, std_g = np.zeros(n), np.zeros((n, dim))
    bvec = None
    if partial:
        bvec = np.ones(n, bool)
        bvec[[1, 4]] = False
        g = g[bvec]
        std_g = None if std_g is None else std_g[bvec]
    xp, fp, sfp = x, f, std_f
    if n_pad:
        xp = np.concatenate([x, np.tile(x[:1], (n_pad, 1))])
        fp = np.concatenate([f, np.zeros(n_pad)])
        sfp = None if std_f is None else np.concatenate([std_f, np.zeros(n_pad)])
    out = {}
    for key, pkg, arr in (("j", jgp, jnp.asarray),
                          ("t", tgp, lambda a: torch.as_tensor(a, dtype=torch.float64))):
        cfg = pkg.GpConfig(dim=dim, use_grad=True, kernel_type=ktype,
                           wellcond_mtd=wellcond)
        spec = pkg.make_data_spec(dim, True, n, std_fval=std_f, std_grad=std_g,
                                  bvec_use_grad=bvec, n_pad_eval=n_pad)
        data = pkg.GpData(x=arr(xp), fval=arr(fp),
                          std_fval=None if sfp is None else arr(sfp),
                          grad=arr(g),
                          std_grad=None if std_g is None else arr(std_g))
        info = pkg.HpInfo(dim=dim, has_kernel=cfg.kernel_has_hp,
                          has_varK=spec.b_has_noisy_data,
                          has_var_fval=spec.b_optz_var_fval,
                          has_var_fgrad=spec.b_optz_var_fgrad)
        out[key] = dict(cfg=cfg, spec=spec, data=data, info=info)
    assert out["j"]["spec"].__dict__ == out["t"]["spec"].__dict__
    assert out["j"]["info"].__dict__ == out["t"]["info"].__dict__
    out["eta"] = jcond.calc_etaK(out["j"]["cfg"], n)
    assert out["eta"] == tcond.calc_etaK(out["t"]["cfg"], n)
    return out


def hp_vec(p, seed=1):
    """A log-space hyperparameter vector valid for the problem's layout."""
    info = p["t"]["info"]
    rng = np.random.default_rng(seed)
    v = list(np.log10(rng.uniform(0.3, 2.0, info.dim)))
    if info.has_kernel:
        v.append(np.log10(2.5))
    for has, val in ((info.has_varK, 1.7), (info.has_var_fval, 3e-3),
                     (info.has_var_fgrad, 5e-3)):
        if has:
            v.append(np.log10(val))
    return np.asarray(v)


def _jax_mll_grad(p, v):
    """The JAX package's objective, jitted as its fit runs it (eager JAX
    compiles every op separately and takes several times longer)."""
    j = p["j"]
    fn = jax.jit(lambda vv: jlkd.neg_mll_and_grad(
        j["cfg"], j["spec"], j["info"], j["data"], vv, p["eta"]))
    val, g, lkd = fn(jnp.asarray(v))
    return float(val), np.asarray(g), lkd


def _torch_mll_grad(p, v):
    t = p["t"]
    val, g, lkd = tlkd.neg_mll_and_grad(t["cfg"], t["spec"], t["info"],
                                        t["data"], torch.as_tensor(v), p["eta"])
    return float(val), g.numpy(), lkd


@pytest.mark.parametrize("ktype", KERNELS)
@pytest.mark.parametrize("wellcond", ["base", "precon"])
@pytest.mark.parametrize("n_pad", [0, 3])
def test_assemble_keta_matches_jax(ktype, wellcond, n_pad):
    p = problem(ktype, wellcond=wellcond, n_pad=n_pad)
    v = hp_vec(p)
    j, t = p["j"], p["t"]
    hp_j = jgp.hp_vec_to_hypers(j["info"], jnp.asarray(v))
    hp_t = tgp.hp_vec_to_hypers(t["info"], torch.as_tensor(v))
    ops_j = jax.jit(lambda h: jassembly.assemble_keta(
        j["cfg"], j["spec"], j["data"], h, p["eta"]))(hp_j)
    ops_t = tassembly.assemble_keta(t["cfg"], t["spec"], t["data"], hp_t,
                                    p["eta"])
    assert bool(ops_t.ok) and bool(ops_j.ok)
    for name in ("M", "pvec", "etaK"):
        np.testing.assert_allclose(getattr(ops_t, name).numpy(),
                                   np.asarray(getattr(ops_j, name)),
                                   rtol=1e-12, atol=1e-13, err_msg=name)
    # two LAPACK builds factor M (cond up to ~1e8 here) in different orders
    np.testing.assert_allclose(ops_t.logdet.numpy(), np.asarray(ops_j.logdet),
                               rtol=1e-10)
    np.testing.assert_allclose(ops_t.fac.L.numpy(), np.asarray(ops_j.fac.L),
                               rtol=1e-10, atol=1e-11)


# (kernel, noise regime, conditioning, padding, partial gradient set)
LKD_CASES = ([(k, nz, "precon", 0, False) for k in KERNELS
              for nz in (None, "known", "unknown")]
             + [("SqExp", None, "base", 0, False),
                ("SqExp", "unknown", "base", 0, False),
                ("Ma5f2", None, "precon", 2, False),
                ("RatQu", "known", "precon", 0, True)])


@pytest.mark.parametrize("ktype,noise,wellcond,n_pad,partial", LKD_CASES)
def test_neg_mll_and_grad_match_jax(ktype, noise, wellcond, n_pad, partial):
    """MLL to rtol 1e-9 and its hp gradient to rtol 1e-6 at the same hp
    vector, plus the closed-form beta / varK."""
    p = problem(ktype, noise=noise, wellcond=wellcond, n_pad=n_pad,
                partial=partial)
    v = hp_vec(p)
    val_j, g_j, lkd_j = _jax_mll_grad(p, v)
    val_t, g_t, lkd_t = _torch_mll_grad(p, v)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-9)
    np.testing.assert_allclose(g_t, g_j, rtol=1e-6,
                               atol=1e-9 * np.max(np.abs(g_j)))
    for name in ("beta", "varK", "ln_det", "etaK"):
        np.testing.assert_allclose(getattr(lkd_t, name).numpy(),
                                   np.asarray(getattr(lkd_j, name)),
                                   rtol=1e-9, err_msg=name)


@pytest.mark.parametrize("norm", [2, "fro"])
def test_condition_numbers_match_jax(norm):
    p = problem("Ma5f2")
    v = hp_vec(p)
    t, j = p["t"], p["j"]
    lk_t = tlkd.calc_lkd(t["cfg"].replace(cond_norm=norm), t["spec"],
                         t["data"],
                         tgp.hp_vec_to_hypers(t["info"], torch.as_tensor(v)),
                         p["eta"], calc_cond=True)
    fn = jax.jit(lambda vv: jlkd.calc_lkd(
        j["cfg"].replace(cond_norm=norm), j["spec"], j["data"],
        jgp.hp_vec_to_hypers(j["info"], vv), p["eta"], calc_cond=True))
    lk_j = fn(jnp.asarray(v))
    # two libraries' eigen/Cholesky solvers on a matrix of cond ~1e8
    np.testing.assert_allclose(float(lk_t.cond), float(lk_j.cond), rtol=1e-6)


def test_batched_rows_and_failed_cholesky_fallback():
    """A batch of hp rows evaluates each row as it would alone; a row whose
    Cholesky fails gets the restoring fallback objective and a finite
    gradient, in both packages, without touching the other rows."""
    p = problem("SqExp", n=6)
    v_good = hp_vec(p)
    v_bad = np.full_like(v_good, -18.0)   # theta 1e-18: K's value block is all ones
    eta0 = 0.0                            # and no nugget: not positive definite
    t, j = p["t"], p["j"]
    V = torch.as_tensor(np.stack([v_good, v_bad, v_good + 0.1]))
    val_b, g_b, lkd_b = tlkd.neg_mll_and_grad(t["cfg"], t["spec"], t["info"],
                                              t["data"], V, eta0)
    assert lkd_b.ok.tolist() == [True, False, True]
    assert torch.isfinite(val_b).all() and torch.isfinite(g_b).all()
    for r in (0, 2):
        val_1, g_1, _ = tlkd.neg_mll_and_grad(t["cfg"], t["spec"], t["info"],
                                              t["data"], V[r], eta0)
        np.testing.assert_allclose(val_b[r].numpy(), val_1.numpy(), rtol=1e-13)
        np.testing.assert_allclose(g_b[r].numpy(), g_1.numpy(), rtol=1e-10,
                                   atol=1e-12)
    fn = jax.jit(lambda vv: jlkd.neg_mll(j["cfg"], j["spec"], j["info"],
                                         j["data"], vv, eta0))
    for r in range(3):
        val_j, lkd_j = fn(jnp.asarray(V[r].numpy()))
        assert bool(lkd_j.ok) == bool(lkd_b.ok[r])
        np.testing.assert_allclose(val_b[r].numpy(), float(val_j), rtol=1e-9)
