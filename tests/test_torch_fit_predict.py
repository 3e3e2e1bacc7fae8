"""Parity of the port's fit and prediction with the JAX package, in float64
on the CPU: LHS starts and bounds, the batched L-BFGS, fit_map's optimum,
and eval_model / eval_model_var with the JAX package's hyperparameters
carried over through gpgradpy_torch.convert."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lkd import problem

import gpgradpy_tpu as jgp
from gpgradpy_tpu.fit import history as jhist
from gpgradpy_tpu.fit import lbfgs as jlbfgs
from gpgradpy_tpu.fit import lhs as jlhs
from gpgradpy_tpu.fit import multistart as jms
from gpgradpy_tpu.model import likelihood as jlkd
from gpgradpy_tpu.model import predict as jpred
import gpgradpy_torch as tgp
from gpgradpy_torch import convert
from gpgradpy_torch.fit import history as thist
from gpgradpy_torch.fit import lbfgs as tlbfgs
from gpgradpy_torch.fit import lhs as tlhs
from gpgradpy_torch.fit import multistart as tms
from gpgradpy_torch.model import predict as tpred


@pytest.mark.parametrize("d", [1, 3])
def test_lhs_starts_and_bounds_identical(d):
    p = problem("RatQu", noise="unknown", dim=d, n=6)
    hist = {}
    for key, mod in (("j", jhist), ("t", thist)):
        h = mod.FitHistory(4, d, 1)
        h.hp_theta[:2] = [[0.3] * d, [0.5] * d]
        h.hp_kernel[:2] = [1.5, 2.5]
        h.hp_varK[:2] = [2.0, 3.0]
        hist[key] = h
    for i_optz in (0, 2):
        bj = jms.get_hp_bounds(p["j"]["cfg"], p["j"]["info"], hist["j"], i_optz)
        bt = tms.get_hp_bounds(p["t"]["cfg"], p["t"]["info"], hist["t"], i_optz)
        for a, b in zip(bt, bj):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tlhs.lhs_sample(41, bt.lhs_lb, bt.lhs_ub, seed=1),
            jlhs.lhs_sample(41, bj.lhs_lb, bj.lhs_ub, seed=1))


def test_lbfgs_follows_jax_iterates():
    """Box-constrained Rosenbrock from three starts: the batched numpy
    L-BFGS takes the JAX version's iterates (same count, same optimum)."""
    lb, ub = np.array([-1.5, -0.5]), np.array([2.0, 0.8])
    x0 = np.array([[-1.2, 0.7], [1.8, -0.4], [0.3, 0.3]])

    def f_np(X):
        a, b = X[:, 0], X[:, 1]
        f = (1 - a) ** 2 + 20 * (b - a * a) ** 2
        g = np.stack([-2 * (1 - a) - 80 * a * (b - a * a),
                      40 * (b - a * a)], 1)
        return f, g, np.zeros(len(X))

    def f_jax(x):
        f = (1 - x[0]) ** 2 + 20 * (x[1] - x[0] ** 2) ** 2
        return f, jax.grad(lambda y: (1 - y[0]) ** 2
                           + 20 * (y[1] - y[0] ** 2) ** 2)(x)

    want = jax.jit(lambda X: jlbfgs.lbfgs_box_multistart(
        f_jax, X, jnp.asarray(lb), jnp.asarray(ub), max_iter=60))(
            jnp.asarray(x0))
    got = tlbfgs.lbfgs_box_multistart(f_np, x0, lb, ub, max_iter=60)
    np.testing.assert_array_equal(got.n_iter, np.asarray(want.n_iter))
    np.testing.assert_array_equal(got.converged, np.asarray(want.converged))
    np.testing.assert_allclose(got.x, np.asarray(want.x), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got.f, np.asarray(want.f), rtol=1e-9, atol=1e-15)


FIT_CASES = [("RatQu", None, "hp_best"), ("Ma5f2", "unknown", "lhs")]


@pytest.mark.parametrize("ktype,noise,start", FIT_CASES)
def test_fit_map_matches_jax(ktype, noise, start):
    """The same -ln L at the optimum to rtol 1e-6 (the two optimizers stop
    on tol_f 1e-12 after a slightly different number of steps)."""
    p = problem(ktype, noise=noise, n=10)
    res = {}
    for key, mod in (("j", jms), ("t", tms)):
        s = p[key]
        cfg = s["cfg"].replace(lkd_optz_start_mtd=start, optz_n_x0=3)
        res[key] = mod.fit_map(cfg, s["spec"], s["info"], s["data"], p["eta"])
    np.testing.assert_allclose(res["t"].neg_lkd, float(res["j"].neg_lkd),
                               rtol=1e-6)
    assert set(res["t"].info) == set(res["j"].info)
    assert res["t"].info["optz_n_cho_fail"] == res["j"].info["optz_n_cho_fail"]


PRED_CASES = [("RatQu", None, 0), ("Ma5f2", "known", 2)]


@pytest.mark.parametrize("ktype,noise,n_pad", PRED_CASES)
def test_eval_model_matches_jax(ktype, noise, n_pad):
    """mu, std, their gradients and Hessians, and the variance path, with
    the JAX package's hyperparameters carried over through convert."""
    p = problem(ktype, noise=noise, n_pad=n_pad)
    j, t = p["j"], p["t"]
    rng = np.random.default_rng(9)
    hp = dict(theta=rng.uniform(0.4, 1.5, 2),
              kernel=2.5 if ktype == "RatQu" else None,
              varK=1.3 if noise else None)
    hp_j = jgp.Hypers(**{k: None if v is None else jnp.asarray(v)
                         for k, v in hp.items()})
    hp_j = jlkd.closed_form_hp(j["cfg"], j["spec"], j["data"], hp_j, p["eta"])
    hp_t = convert.hypers_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in hp_j._asdict().items()}, device="cpu")
    xq = rng.uniform(-0.9, 0.9, (4, 2))

    def jax_eval(data, hpj, x):
        st = jpred.setup_eval(j["cfg"], j["spec"], data, hpj, p["eta"])
        return (jpred.eval_model(j["cfg"], j["spec"], data, st, x,
                                 calc_grad=True, calc_hess=True)
                + jpred.eval_model_var(j["cfg"], j["spec"], data, st, x,
                                       calc_grad=True, calc_hess=True))
    want = jax.jit(jax_eval)(j["data"], hp_j, jnp.asarray(xq))
    st = tpred.setup_eval(t["cfg"], t["spec"], t["data"], hp_t, p["eta"])
    xt = torch.as_tensor(xq)
    got = (tpred.eval_model(t["cfg"], t["spec"], t["data"], st, xt,
                            calc_grad=True, calc_hess=True)
           + tpred.eval_model_var(t["cfg"], t["spec"], t["data"], st, xt,
                                  calc_grad=True, calc_hess=True))
    names = ("mu", "sig", "dmu", "dsig", "d2mu", "d2sig",
             "sig2", "dsig2", "d2sig2")
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        # the std family comes from 1 - k^T Keta^-1 k with Keta at cond up
        # to 1e10: two LAPACK builds' solves differ there by ~1e-9 of the
        # largest entry, so it gets that floor; the mean family 1e-10
        floor = 1e-10 if name in ("mu", "dmu", "d2mu") else 1e-8
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-8,
                                   atol=floor * np.max(np.abs(b)), err_msg=name)
    back = convert.hypers_to_numpy(hp_t)
    for k, v in hp_j._asdict().items():
        if v is not None:
            np.testing.assert_array_equal(back[k], np.asarray(v))


def test_convert_hp_info_layout():
    info_j = jgp.HpInfo(dim=3, has_kernel=True, has_varK=True,
                        has_var_fval=True)
    info_t = convert.hp_info_from_layout(dataclasses.asdict(info_j))
    assert info_t.n_hp == info_j.n_hp
    np.testing.assert_array_equal(info_t.bvec_log, info_j.bvec_log)
    v = np.log10(np.array([0.5, 0.7, 0.9, 2.0, 1.5, 1e-3]))
    hj = jgp.hp_vec_to_hypers(info_j, jnp.asarray(v))
    ht = convert.hypers_from_numpy(
        {k: None if a is None else np.asarray(a)
         for k, a in hj._asdict().items()}, device="cpu")
    np.testing.assert_allclose(
        jgp.hypers_to_hp_vec(info_j, hj),
        tgp.hypers_to_hp_vec(info_t, ht).numpy(),
        rtol=1e-14)
