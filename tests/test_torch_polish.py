"""The f32 fit with the f64 polish and the mixed-precision refined predict
of the port, against the JAX package (CPU, x64 on) and against the port's
own f64 path.

Tolerances:
- ``refine_solve``: both packages' refined solves on one f32 factor within
  1e-10 (relative) of the f64 solve at cond ~1e4;
- the refined predict: within 1e-6 of the f64 predict and 100x better than
  plain f32 wherever f32 misses 1e-5 (the JAX package's own criteria,
  tests/test_refine.py); within 2e-6 of the JAX package's refined predict;
- ``_polish_fit`` from one shared start: -ln L to rtol 1e-8;
- the polished facade: -ln L to rtol 1e-6 against the JAX facade (the
  f32 main fits of two LAPACKs stop at different points), predictions as
  in test_torch_facade.test_facade_matches_jax (rtol 1e-3, floor 1e-3 of
  the largest entry: theta moves along a flat direction);
- a query the f32 grid cannot hold: the polished predict within 1e-12
  (relative) of the f64 predict.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_tpu.fit.multistart import FitResult as JaxFit
from gpgradpy_tpu.ops import linalg as jlinalg
from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.fit.multistart import FitResult
from gpgradpy_torch.ops import linalg

POLISH = dict(dtype="float32", cond_max_target=1e6, polish_cond_target=1e10,
              polish_iter_max=10)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / max(np.linalg.norm(b), 1e-30)


def _data(n=12, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    xq = rng.uniform(-1.5, 1.5, (5, d))
    return x, f, g, xq


def _gp(cls, x, f, g, **kw):
    n, d = x.shape
    gp = cls(d, True, "SqExp", "precon", **kw)
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
    return gp


@pytest.fixture(scope="module")
def jax_polished():
    """The JAX facade's polished fit, shared by the facade tests."""
    x, f, g, xq = _data()
    gp = _gp(JaxGP, x, f, g, **POLISH)
    gp.set_hpara("optz", 0)
    return gp


def test_refine_solve_matches_jax():
    rng = np.random.default_rng(0)
    n = 80
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * np.logspace(-4, 0, n)) @ Q.T            # cond 1e4
    M = 0.5 * (M + M.T)
    b = rng.standard_normal((n, 2))
    x_exact = np.linalg.solve(M, b)
    L32 = np.linalg.cholesky(M.astype(np.float32))   # one f32 factor for both

    fac_t = linalg.CholFac(torch.as_tensor(L32), torch.tensor(True))
    x_t = linalg.refine_solve(fac_t, torch.as_tensor(M), torch.as_tensor(b),
                              3).numpy()
    fac_j = jlinalg.CholFac(jnp.asarray(L32), jnp.asarray(True))
    x_j = np.asarray(jlinalg.refine_solve(fac_j, jnp.asarray(M),
                                          jnp.asarray(b), 3))
    x_plain = linalg.cho_solve(fac_t, torch.as_tensor(b, dtype=torch.float32))
    assert x_t.dtype == np.float64
    assert _rel(x_t, x_exact) < 1e-10
    assert _rel(x_j, x_exact) < 1e-10
    assert _rel(x_plain.numpy(), x_exact) > 1e-6   # what refinement fixes


def _refine_problem(d=2, n=24, seed=0):
    """f32-representable inputs, so that the f64 and f32 models see the
    same data (tests/test_refine.py of the JAX package)."""
    rng = np.random.default_rng(seed)
    x = np.float32(rng.uniform(-2, 2, (n, d))).astype(np.float64)
    f, g = rosenbrock(x, a=10.0)
    return (x, np.float32(f).astype(np.float64),
            np.float32(g).astype(np.float64))


def _set_eval(cls, dtype, n_refine, xq, **kw):
    x, f, g = _refine_problem()
    gp = _gp(cls, x, f, g, dtype=dtype, n_refine_predict=n_refine,
             cond_max_target=1e6, **kw)
    gp.set_hpara("set", 0, hp_vals=gp.make_hp_class(
        theta=np.array([30.0, 30.0])))
    return [np.asarray(v) for v in gp.eval_model(xq, calc_grad=True)[:4]]


def test_refined_predict_recovers_f64_and_matches_jax():
    rng = np.random.default_rng(3)
    xq = np.float32(rng.uniform(-2, 2, (16, 2))).astype(np.float64)
    exact = _set_eval(GaussianProcess, "float64", 0, xq, device="cpu")
    plain = _set_eval(GaussianProcess, "float32", 0, xq, device="cpu")
    refined = _set_eval(GaussianProcess, "float32", 2, xq, device="cpu")
    refined_j = _set_eval(JaxGP, "float32", 2, xq)
    for k, name in enumerate(("mu", "sig", "dmu", "dsig")):
        assert refined[k].dtype == np.float64
        e_plain, e_ref = _rel(plain[k], exact[k]), _rel(refined[k], exact[k])
        assert e_ref < 1e-6, (name, e_ref)
        if e_plain > 1e-5:
            assert e_ref < 0.01 * e_plain, (name, e_plain, e_ref)
        assert _rel(refined[k], refined_j[k]) < 2e-6, name


def test_refined_model_mean_with_data_refines():
    """calc_model_mean_w_data_init with the original data reproduces the
    refined eval_model: its solve is refined too."""
    x, f, g = _refine_problem()
    xq = np.array([[0.3, -0.7], [1.1, 0.4]])
    gp = _gp(GaussianProcess, x, f, g, dtype="float32", n_refine_predict=2,
             cond_max_target=1e6, device="cpu")
    gp.set_hpara("set", 0, hp_vals=gp.make_hp_class(
        theta=np.array([30.0, 30.0])))
    mu, _, dmu, *_ = gp.eval_model(xq, calc_grad=True)
    mu2, dmu2 = gp.calc_model_mean_w_data_init(xq, f, g)
    np.testing.assert_allclose(mu2, mu, rtol=1e-9)
    np.testing.assert_allclose(dmu2, dmu, rtol=1e-8, atol=1e-9)


def test_polish_fit_from_a_shared_start_matches_jax():
    x, f, g, _ = _data()
    x0 = np.array([-1.3, -3.2])                 # near the optimum, log10 theta
    gp_t = _gp(GaussianProcess, x, f, g, device="cpu", **POLISH)
    gp_t.optz_infos = []
    fit_t = gp_t._polish_fit(FitResult(x0, np.nan, 123.0, {"a": 1}), 0)
    gp_j = _gp(JaxGP, x, f, g, **POLISH)
    fit_j = gp_j._polish_fit(JaxFit(jnp.asarray(x0), np.nan, 123.0,
                                    {"a": 1}), 0)
    np.testing.assert_allclose(fit_t.neg_lkd, float(fit_j.neg_lkd),
                               rtol=1e-8)
    np.testing.assert_allclose(fit_t.hp_vec, np.asarray(fit_j.hp_vec),
                               rtol=1e-5, atol=1e-6)
    # the main fit's cond and telemetry are kept; the polish's iterations
    # are capped at polish_iter_max and recorded in optz_infos
    assert fit_t.cond == 123.0 and fit_t.info == {"a": 1}
    assert gp_t.optz_infos[-1]["polish"]
    assert gp_t.optz_infos[-1]["hp_optz_iter_max"] <= 10


def test_polished_facade_matches_jax(jax_polished):
    x, f, g, xq = _data()
    gp_t = _gp(GaussianProcess, x, f, g, device="cpu", **POLISH)
    gp_t.set_hpara("optz", 0)
    gp_j = jax_polished
    np.testing.assert_allclose(gp_t.history.ln_lkd[0],
                               gp_j.history.ln_lkd[0], rtol=1e-6)
    assert [i.get("polish", False) for i in gp_t.optz_infos] == [False, True]
    assert gp_t.hp_vals.theta.dtype == torch.float64
    assert gp_t.data.x.dtype == torch.float32          # the fit's data
    for got, want in zip(gp_t.eval_model(xq, calc_grad=True)[:4],
                         gp_j.eval_model(xq, calc_grad=True)[:4]):
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-3 * np.max(np.abs(want)))


def test_query_is_cast_to_the_predict_precision():
    """A polished model (f32 data, f64 predict) at fixed hyperparameters
    against the f64 model at the polish target: the same covariance, so
    at query coordinates that f32 cannot hold they must agree to round-off.
    Casting the queries to the f32 fit dtype moves mu by ~1e-7."""
    x, f, g = _refine_problem()
    xq = np.array([[0.1234567891234, -0.9876543219876],
                   [1.0000000123456, 0.3333333333333]])
    out = {}
    for key, kw in (("polish", POLISH), ("f64", dict(cond_max_target=1e10))):
        gp = _gp(GaussianProcess, x, f, g, device="cpu", **kw)
        gp.set_hpara("set", 0, hp_vals=gp.make_hp_class(
            theta=np.array([0.5, 0.25])))
        out[key] = (gp.eval_model(xq, calc_grad=True)[:4]
                    + gp.eval_model_var(xq, calc_grad=True)[:2])
        if key == "polish":
            assert gp._predict_dtype == torch.float64
            predict = gp.make_predict_fn()
            out["fn"] = predict(xq)[:2]
    for got, want in zip(out["polish"], out["f64"]):
        assert _rel(got, want) < 1e-12
    for got, want in zip(out["fn"], out["f64"][:2]):
        assert _rel(got.numpy(), want) < 1e-12
