"""The port's utils (telemetry tables, MLL contour, gradient check) and the
scalar-kernel oracle, against the JAX package (CPU, float64).

Tolerances: the telemetry text equal to the JAX package's line by line,
but for the option line of the field only the JAX config has
(``use_pallas``) and, after each package's own fits, the timing and
iteration columns of the optimization table and the float cells, held to
one unit of their last printed digit (test_txt_info_matches_jax);
``lkd_grid`` to rtol 1e-9 at rows with cond < 1e9, 1e-7 at the others;
``test_grad_calc`` equal; ``gamma2theta`` equal, ``scalar_kernel`` and its
autograd derivatives to rtol 1e-12 of the JAX package's and 1e-12 of the
port's closed-form blocks.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, jacfwd

from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_tpu.ops import kernels as jkernels
from gpgradpy_tpu.utils import lkd_contour as jlkd_contour
from gpgradpy_tpu.utils.gradcheck import test_grad_calc as jax_grad_check
from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.fit import multistart
from gpgradpy_torch.ops import kernels, rtensor
from gpgradpy_torch.utils import lkd_contour
from gpgradpy_torch.utils.gradcheck import test_grad_calc as fd_grad_check

KERNELS = ["SqExp", "Ma5f2", "RatQu"]
ALPHA = {"SqExp": None, "Ma5f2": None, "RatQu": 2.0}
JAX_ONLY_OPTIONS = ("use_pallas",)


def _problem_2d(n=10):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (n, 2))
    return x, np.sum(x ** 2, axis=1), 2.0 * x


def _fit(cls, x, f, g, **kw):
    n, d = x.shape
    gp = cls(d, True, "SqExp", "precon", **kw)
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
    gp.set_hpara("optz", 0)
    return gp


@pytest.fixture(scope="module")
def jax_gp_2d():
    return _fit(JaxGP, *_problem_2d())


def _rounds(gp):
    """Round 0 on one point (the constant initial hyperparameters), round
    1 a fit on eight (the sin(x) + sin(10x/3) problem)."""
    x = np.linspace(2.5, 7.5, 8)[:, None]
    f = np.sin(x[:, 0]) + np.sin(10 * x[:, 0] / 3)
    g = (np.cos(x[:, 0]) + (10 / 3) * np.cos(10 * x[:, 0] / 3))[:, None]
    gp.init_optz_surr(3)
    for i, n in enumerate((1, 8)):
        gp.set_data(x[:n], f[:n], np.zeros(n), g[:n], np.zeros((n, 1)))
        gp.set_hpara("optz", i)
    return gp


def _lines(text, drop_cols=()):
    """The text's lines without the JAX-only option lines, and without the
    columns ``drop_cols`` of the optimization table."""
    lines, in_optz = [], False
    for line in text.splitlines():
        if line.split(" = ")[0].strip() in JAX_ONLY_OPTIONS:
            continue
        in_optz = in_optz or line.startswith("Optimization stats:")
        if in_optz and len(line.split()) == 11:
            line = [c for i, c in enumerate(line.split())
                    if i not in drop_cols]
        lines.append(line)
    return lines


_PRINTED_FLOAT = re.compile(r"-?\d+(\.\d*)?(e[+-]\d+)?$")


def _last_digit(tok):
    """One unit in the last printed digit of a float cell ("7.153e+08" ->
    1e5, "17.531" -> 1e-3)."""
    mant, _, exp = tok.partition("e")
    return 10.0 ** (int(exp or 0) - len(mant.partition(".")[2]))


def _agree_as_printed(lines_t, lines_j):
    """The lines equal but for float cells (with a point or an exponent)
    that lie within one unit of their last printed digit of each other:
    two values a rounding boundary apart print differently however close
    they are."""
    assert len(lines_t) == len(lines_j)
    for lt, lj in zip(lines_t, lines_j):
        if lt == lj:
            continue
        ct = lt if isinstance(lt, list) else lt.split()
        cj = lj if isinstance(lj, list) else lj.split()
        assert len(ct) == len(cj), (lt, lj)
        for a, b in zip(ct, cj):
            if a == b:
                continue
            assert ("." in a + b or "e" in a + b) and all(
                _PRINTED_FLOAT.match(c) for c in (a, b)), (lt, lj)
            assert abs(float(a) - float(b)) <= 1.000001 * max(
                _last_digit(a), _last_digit(b)), (lt, lj)


def test_txt_info_matches_jax():
    """After the same rounds the texts agree, as printed (each float cell
    within one unit of its last digit: the fitted optimum's cond(M) reads
    7.1520e8 on one BLAS path and 7.1527e8 in the JAX package), but for
    the option line of the JAX-only field, the timing columns and the
    L-BFGS iteration columns.  On this flat 1-D likelihood the two
    optimizers stop up to two iterations apart (7 to 9 over the BLAS paths
    against JAX's 7), a count that rests on round-off: where they stop is
    held instead, -ln L to rtol 1e-9 and theta to 2e-5 (ROADMAP.md, "Flat
    optima"; readings <= 6.2e-10 and 8.9e-6).  With the JAX package's
    history loaded into the port's facade, the texts agree exactly but
    for the option lines."""
    gp_t = _rounds(GaussianProcess(1, True, "SqExp", "precon", device="cpu"))
    gp_j = _rounds(JaxGP(1, True, "SqExp", "precon"))
    text_t, text_j = gp_t.get_txt_info_surr(), gp_j.get_txt_info_surr()
    skipped = [ln for ln in text_j.splitlines()
               if ln.split(" = ")[0].strip() in JAX_ONLY_OPTIONS]
    assert len(skipped) == len(JAX_ONLY_OPTIONS)
    assert "Theta history:" in text_t and "cond_at_max" in text_t
    _agree_as_printed(_lines(text_t, drop_cols=(2, 3, 8, 9, 10)),
                      _lines(text_j, drop_cols=(2, 3, 8, 9, 10)))
    h_t, h_j = gp_t.history, gp_j.history
    np.testing.assert_allclose(h_t.ln_lkd[1], h_j.ln_lkd[1], rtol=1e-9)
    np.testing.assert_allclose(h_t.hp_theta[1], h_j.hp_theta[1], rtol=2e-5)
    for h in (h_t, h_j):
        assert 1 <= h.hp_optz_iter_max[1] < gp_t.cfg.optz_iter_max

    gp_t.load_data_surr(all_data=gp_j.export_data_surr(save2file=False))
    assert _lines(gp_t.get_txt_info_surr()) == _lines(text_j)


def test_lkd_grid_matches_jax(jax_gp_2d):
    x, f, g = _problem_2d()
    gp_t = _fit(GaussianProcess, x, f, g, device="cpu")
    vi_t, vj_t, val_t = lkd_contour.lkd_grid(gp_t, (0, 1), 5)
    vi_j, vj_j, val_j = jlkd_contour.lkd_grid(jax_gp_2d, (0, 1), 5)
    np.testing.assert_array_equal(vi_t, vi_j)
    np.testing.assert_array_equal(vj_t, vj_j)
    assert val_t.shape == (5, 5) and np.isfinite(val_t).sum() >= 20
    # rows at cond >= 1e9 (the grid reaches 6.7e9): two LAPACK builds set
    # -ln L ~1e-8 apart there (ROADMAP Queue 3, "Two LAPACKs")
    Xi, Xj = np.meshgrid(vi_t, vj_t)
    cond = multistart.lkd_cond_at(
        gp_t.cfg, gp_t.spec, gp_t.hp_info_optz_lkd, gp_t.data,
        float(gp_t._etaK), np.stack([Xi.ravel(), Xj.ravel()], 1)).cond
    tame = cond.numpy().reshape(5, 5) < 1e9
    assert tame.sum() >= 10
    np.testing.assert_allclose(val_t[tame], val_j[tame], rtol=1e-9)
    np.testing.assert_allclose(val_t, val_j, rtol=1e-7)
    # one row of the batch (cond 8e7) against a single evaluation
    hp = gp_t.make_hp_class(theta=10.0 ** np.array([vi_t[2], vj_t[3]]))
    lkd, _ = gp_t.calc_lkd_all(hp)
    np.testing.assert_allclose(val_t[3, 2], -float(lkd.ln_lkd), rtol=1e-10)


def test_plt_debug_lkd_writes_a_png(tmp_path):
    x, f, g = _problem_2d()
    gp = _fit(GaussianProcess, x, f, g, device="cpu")
    out = tmp_path / "lkd.png"
    lkd = gp.plt_debug_lkd(i_optz=0, dims=(0, 1), n_grid=6, path=str(out),
                           hp_x0=np.zeros((2, 2)), hp_optz=np.zeros(2))
    assert lkd.shape == (6, 6)
    assert np.isfinite(lkd).any()
    assert out.exists() and out.stat().st_size > 0


def test_grad_calc_matches_jax(capsys):
    def fun(v):
        return np.array([np.sum(v ** 2), np.prod(v)])

    def jac(v):
        return np.array([2 * v, [v[1], v[0]]])

    x0 = np.array([1.0, 2.0])
    got = fd_grad_check(x0, fun, jac, print_calc=True)
    out_t = capsys.readouterr().out
    want = jax_grad_check(x0, fun, jac, print_calc=True)
    out_j = capsys.readouterr().out
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert out_t == out_j and "FD test" in out_t
    fd, gr = fd_grad_check(x0, lambda v: np.sum(v ** 2), lambda v: 2 * v,
                           print_calc=False, calc_cent_diff=False)
    np.testing.assert_allclose(fd, gr, rtol=1e-6)


@pytest.mark.parametrize("ktype", KERNELS)
def test_gamma2theta_and_scalar_kernel(ktype):
    rng = np.random.default_rng(1)
    gamma = rng.uniform(0.1, 3.0, 4)
    np.testing.assert_array_equal(
        kernels.gamma2theta(ktype, torch.as_tensor(gamma)).numpy(),
        np.asarray(jkernels.gamma2theta(ktype, jnp.asarray(gamma))))
    np.testing.assert_allclose(
        kernels.theta2gamma(ktype, kernels.gamma2theta(
            ktype, torch.as_tensor(gamma))).numpy(), gamma, rtol=1e-15)

    dim, alpha = 3, ALPHA[ktype]
    x1, x2 = rng.uniform(-1, 1, (2, dim))
    theta = rng.uniform(0.5, 2.0, dim)
    t1, t2, tt = (torch.as_tensor(v) for v in (x1, x2, theta))

    def k(a, b):
        return kernels.scalar_kernel(ktype, a, b, tt, alpha)

    def kj(a, b):
        return jkernels.scalar_kernel(ktype, a, b, jnp.asarray(theta), alpha)

    got = [k(t1, t2), grad(k)(t1, t2), grad(k, argnums=1)(t1, t2),
           jacfwd(grad(k), argnums=1)(t1, t2), hessian(k)(t1, t2)]
    a, b = jnp.asarray(x1), jnp.asarray(x2)
    want = [kj(a, b), jax.grad(kj)(a, b), jax.grad(kj, argnums=1)(a, b),
            jax.jacfwd(jax.grad(kj), argnums=1)(a, b), jax.hessian(kj)(a, b)]
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-12,
                                   atol=1e-14)

    # the port's closed-form blocks at the same pair of points
    G = kernels.kern_block_tensor(ktype, rtensor.calc_rtensor(t1[None],
                                                              t2[None]),
                                  tt, alpha)[..., 0, 0].numpy()
    np.testing.assert_allclose(G[0, 0], got[0].numpy(), rtol=1e-12)
    np.testing.assert_allclose(G[1:, 0], got[1].numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(G[0, 1:], got[2].numpy(), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(G[1:, 1:], got[3].numpy(), rtol=1e-12,
                               atol=1e-14)
