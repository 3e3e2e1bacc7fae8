"""Parity of the port's covariance kernels with the JAX package, in float64
on the CPU: the plain closed forms (ops/kernels), the plain versions of the
CUDA kernels K1/K2 against the Pallas kernels they replace (in interpret
mode) and against ``jax.vjp``, and ``KernGradFn``'s gradient against
autograd of the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gpgradpy_tpu.ops import kernels as jk
from gpgradpy_tpu.ops import pallas_assembly as jpa
from gpgradpy_tpu.ops import rtensor as jrt
from gpgradpy_torch.model.assembly import KernGradFn
from gpgradpy_torch.ops import cuda_assembly as ca
from gpgradpy_torch.ops import kernels as tk
from gpgradpy_torch.ops import rtensor as trt

CASES = [("SqExp", None), ("Ma5f2", None), ("RatQu", 2.0)]
# same closed forms in the same precision: only summation order differs
RTOL, ATOL = 1e-12, 1e-13


def _pts(seed, n1, n2, d, square):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(-1, 1, (n1, d))
    x2 = x1 if square else rng.uniform(-1, 1, (n2, d))
    theta = rng.uniform(0.5, 2, d)
    return x1, x2, theta


def _t(a):
    return None if a is None else torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("ktype,alpha", CASES)
@pytest.mark.parametrize("square", [True, False])
def test_closed_forms_match_jax(ktype, alpha, square):
    x1, x2, theta = _pts(0, 9, 6, 3, square)
    Rj = jrt.calc_rtensor(jnp.asarray(x1), jnp.asarray(x2))
    Rt = trt.calc_rtensor(_t(x1), _t(x2))
    np.testing.assert_array_equal(Rt.numpy(), np.asarray(Rj))
    for name in ("kern_base", "kern_block_tensor", "kern_grad"):
        want = jax.jit(lambda R, th: getattr(jk, name)(ktype, R, th, alpha))(
            Rj, jnp.asarray(theta))
        got = getattr(tk, name)(ktype, Rt, _t(theta), alpha)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("ktype,alpha", CASES)
def test_partial_gradient_sets_and_hessian_match_jax(ktype, alpha):
    x1, x2, theta = _pts(1, 7, 5, 2, False)
    idx1, idx2 = np.array([0, 2, 5]), np.array([1, 4])
    Rj = jrt.calc_rtensor(jnp.asarray(x1), jnp.asarray(x2))
    Rt = trt.calc_rtensor(_t(x1), _t(x2))
    want = jax.jit(lambda R, th: jk.kern_mat(ktype, R, th, alpha, idx_g1=idx1,
                                             idx_g2=idx2))(Rj, jnp.asarray(theta))
    got = tk.kern_mat(ktype, Rt, _t(theta), alpha, idx_g1=idx1, idx_g2=idx2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    for use_grad, idx in ((True, None), (True, idx2), (False, None)):
        want = jax.jit(lambda R, th: jk.kern_hess_x(
            ktype, R, th, alpha, use_grad=use_grad, idx_g2=idx))(
                Rj, jnp.asarray(theta))
        got = tk.kern_hess_x(ktype, Rt, _t(theta), alpha, use_grad=use_grad,
                             idx_g2=idx)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("ktype,alpha", CASES)
def test_batched_rows_equal_single_rows(ktype, alpha):
    """A (B, d) batch of theta rows gives each row's own covariance."""
    x1, x2, _ = _pts(2, 6, 4, 3, False)
    rng = np.random.default_rng(3)
    thetas = rng.uniform(0.3, 3, (4, 3))
    alphas = None if alpha is None else rng.uniform(0.5, 4, 4)
    got = ca.kern_grad_plain(ktype, _t(x1), _t(x2), _t(thetas), _t(alphas))
    for b in range(4):
        one = ca.kern_grad_plain(ktype, _t(x1), _t(x2), _t(thetas[b]),
                                 None if alphas is None else float(alphas[b]))
        np.testing.assert_allclose(got[b].numpy(), one.numpy(), rtol=1e-15,
                                   atol=1e-15)


@pytest.mark.parametrize("ktype,alpha", CASES)
@pytest.mark.parametrize("square", [True, False])
def test_k1_plain_matches_pallas_interpret(ktype, alpha, square):
    """The K1 wrapper on CPU tensors (its plain version) against the Pallas
    kernel it replaces, run in interpret mode."""
    x1, x2, theta = _pts(4, 16, 11, 2, square)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.kern_grad_pallas(ktype, jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(theta), alpha, block=8)
    launches = ca.kern_grad.launches
    got = ca.kern_grad(ktype, _t(x1), _t(x2), _t(theta), alpha)
    assert ca.kern_grad.launches == launches   # CPU tensors: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ktype,alpha", CASES)
@pytest.mark.parametrize("square", [True, False])
def test_k2_plain_matches_pallas_interpret_and_jax_vjp(ktype, alpha, square):
    """The K2 wrapper on CPU tensors against jax.vjp of the closed form and,
    for the square covariance the MLL differentiates, against the Pallas
    theta-cotangent in interpret mode."""
    x1, x2, theta = _pts(5, 16, 11, 2, square)
    n1, n2 = x1.shape[0], x2.shape[0]
    gbar = np.random.default_rng(6).standard_normal((3 * n1, 3 * n2))

    def ref(th):
        return jk.kern_grad(ktype, jrt.calc_rtensor(jnp.asarray(x1),
                                                    jnp.asarray(x2)), th, alpha)
    want_vjp = jax.jit(lambda th, gb: jax.vjp(ref, th)[1](gb)[0])(
        jnp.asarray(theta), jnp.asarray(gbar))
    launches = ca.kern_grad_vjp_theta.launches
    got = ca.kern_grad_vjp_theta(ktype, _t(x1), _t(x2), _t(theta), alpha,
                                 _t(gbar)).numpy()
    assert ca.kern_grad_vjp_theta.launches == launches
    # sums of 9*n1*n2 signed terms in different orders
    np.testing.assert_allclose(got, np.asarray(want_vjp), rtol=1e-11)
    if square:
        with pltpu.force_tpu_interpret_mode():
            want_pallas = jpa.kern_grad_pallas_vjp_theta(
                ktype, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(theta),
                alpha, jnp.asarray(gbar), block=8)
        np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=1e-10)


# The CUDA kernels tile the derivative rows over the grid and K2 reads its
# cotangent in runs of 4 column blocks: d=1 is the fewest blocks (two),
# d=17 gives 18 column blocks, several runs and a ragged last one.  The
# tiling does not depend on the family, and the Pallas kernels in interpret
# mode take ~2.5 s each at d=17 (324 grid steps), so d=17 meets them with
# SqExp only; jax.vjp checks every family at both dims.
EDGE_DIMS = [1, 17]
EDGE_PALLAS = [(kt, al, 1) for kt, al in CASES] + [("SqExp", None, 17)]


@pytest.mark.parametrize("ktype,alpha,d", EDGE_PALLAS)
def test_k1_plain_matches_pallas_interpret_at_edge_dims(ktype, alpha, d):
    """The plain K1 (what chip_smoke.py holds the CUDA K1 to) against the
    Pallas kernel in interpret mode at the edge dims, ragged n=10."""
    x1, _, theta = _pts(9, 10, 10, d, True)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.kern_grad_pallas(ktype, jnp.asarray(x1), jnp.asarray(x1),
                                    jnp.asarray(theta), alpha, block=16)
    got = ca.kern_grad(ktype, _t(x1), _t(x1), _t(theta), alpha)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("ktype,alpha", CASES)
@pytest.mark.parametrize("d", EDGE_DIMS)
@pytest.mark.parametrize("square", [True, False])
def test_k2_plain_and_regrouped_match_jax_at_edge_dims(ktype, alpha, d,
                                                       square):
    """The plain K2 and K2's regrouped contraction (the CUDA kernel's
    algebra) against jax.vjp at the edge dims, square and rectangular
    (n1=10, n2=7), and, square (see EDGE_PALLAS), against the Pallas
    theta-cotangent in interpret mode."""
    x1, x2, theta = _pts(10, 10, 7, d, square)
    n1, n2 = x1.shape[0], x2.shape[0]
    gbar = np.random.default_rng(11).standard_normal(((d + 1) * n1,
                                                      (d + 1) * n2))

    def ref(th):
        return jk.kern_grad(ktype, jrt.calc_rtensor(jnp.asarray(x1),
                                                    jnp.asarray(x2)), th, alpha)
    want = np.asarray(jax.jit(lambda th, gb: jax.vjp(ref, th)[1](gb)[0])(
        jnp.asarray(theta), jnp.asarray(gbar)))
    args = (ktype, _t(x1), _t(x2), _t(theta), alpha, _t(gbar))
    # sums of (1+d)^2 n1 n2 signed terms in different orders
    np.testing.assert_allclose(ca.kern_grad_vjp_theta(*args).numpy(), want,
                               rtol=1e-11)
    np.testing.assert_allclose(ca.kern_grad_vjp_theta_regrouped(*args).numpy(),
                               want, rtol=1e-11)
    if square and (ktype, alpha, d) in EDGE_PALLAS:
        with pltpu.force_tpu_interpret_mode():
            want_pallas = jpa.kern_grad_pallas_vjp_theta(
                ktype, jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(theta),
                alpha, jnp.asarray(gbar), block=16)
        np.testing.assert_allclose(ca.kern_grad_vjp_theta(*args).numpy(),
                                   np.asarray(want_pallas), rtol=1e-10)


@pytest.mark.parametrize("ktype,alpha", CASES)
def test_k2_regrouped_batched_matches_plain(ktype, alpha):
    """K2's regrouped contraction over a (B, d) batch of theta rows (one
    alpha per row) against the plain K2, row by row."""
    x1, x2, _ = _pts(12, 9, 6, 3, False)
    rng = np.random.default_rng(13)
    thetas = rng.uniform(0.3, 3, (2, 3))
    alphas = None if alpha is None else rng.uniform(0.5, 4, 2)
    gbar = _t(rng.standard_normal((2, 4 * 9, 4 * 6)))
    got = ca.kern_grad_vjp_theta_regrouped(ktype, _t(x1), _t(x2), _t(thetas),
                                           _t(alphas), gbar)
    want = ca.kern_grad_vjp_theta(ktype, _t(x1), _t(x2), _t(thetas),
                                  _t(alphas), gbar)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


@pytest.mark.parametrize("ktype,alpha", CASES)
def test_kern_grad_fn_gradient_matches_autograd(ktype, alpha):
    """KernGradFn (K1 forward, K2 theta-backward, plain x/alpha backward)
    against autograd of the plain closed form, batched over theta rows."""
    x, _, _ = _pts(7, 9, 9, 2, True)
    rng = np.random.default_rng(8)
    thetas = rng.uniform(0.3, 3, (3, 2))
    gbar = _t(rng.standard_normal((3, 27, 27)))
    alphas = None if alpha is None else rng.uniform(0.5, 4, 3)

    def grads(use_fn):
        xt = _t(x).requires_grad_(True)
        th = _t(thetas).requires_grad_(True)
        al = None if alphas is None else _t(alphas).requires_grad_(True)
        if use_fn:
            K = KernGradFn.apply(ktype, xt, th, al)
        else:
            K = tk.kern_grad(ktype, trt.calc_rtensor(xt, xt), th, al)
        wrt = [xt, th] + ([] if al is None else [al])
        return [K.detach()] + list(torch.autograd.grad(K, wrt, gbar))

    for got, want in zip(grads(True), grads(False)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
