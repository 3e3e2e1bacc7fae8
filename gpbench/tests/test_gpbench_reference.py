"""The plain reference against gpgradpy_torch on the CPU, float64, d=3,
n_eval=20: covariance, -ln L with its theta gradient and closed form under
both conditioning methods, the predict with its x-gradients, and EI."""

import numpy as np
import pytest
import torch

from gpbench.reference import gp as ref
from gpbench.reference.rosenbrock import rosenbrock

D, N = 3, 20


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    x = rng.uniform(-2, 2, (N, D))
    f, g = rosenbrock(x)
    return x, f, g


def t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def fitted(x, f, g, method, **kw):
    from gpgradpy_torch import GaussianProcess
    gp = GaussianProcess(D, True, "SqExp", method, device="cpu", **kw)
    gp.init_optz_surr(1)
    gp.set_data(x, f, np.zeros(N), g, np.zeros((N, D)))
    gp.set_hpara("optz", 0)
    return gp


def test_rosenbrock_is_the_programs(data):
    from gpgradpy_torch.bo.problems import rosenbrock as prog
    x = data[0]
    for a, b in zip(rosenbrock(x), prog(x)):
        np.testing.assert_array_equal(a, b)


def test_covariance_matches_the_plain_kernels(data):
    from gpgradpy_torch.ops import kernels, rtensor
    x = t(data[0])
    th = t([0.3, 0.7, 1.1])
    K = kernels.kern_mat("SqExp", rtensor.calc_rtensor(x, x), th, None,
                         use_grad=True)
    torch.testing.assert_close(ref.covariance(x, th), K, rtol=0, atol=1e-14)
    xq = t(np.random.default_rng(1).uniform(-2, 2, (4, D)))
    G = kernels.kern_block_tensor("SqExp", rtensor.calc_rtensor(x, xq), th,
                                  None)
    Kq = torch.cat([G[a, 0] for a in range(D + 1)], 0)
    torch.testing.assert_close(ref.covariance(x, th, xq), Kq, rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("method", ["precon", "rescale_origin"])
def test_nugget_policies_match(method):
    from gpgradpy_torch.config import GpConfig
    from gpgradpy_torch.model import conditioning
    cfg = GpConfig(dim=10, wellcond_mtd=method)
    want = ref.eta_precon if method == "precon" else ref.eta_rescale
    for n in (2, 12, 106, 161):
        assert want(n, 10, 1e10) == pytest.approx(
            conditioning.calc_etaK(cfg, n), rel=1e-14)
    assert ref.vreq_rescale(106, 10) == pytest.approx(
        conditioning.calc_mtd_rescale_origin_vreq(106, 10), rel=1e-14)


def test_precon_likelihood_gradient_and_closed_form(data):
    from gpgradpy_torch.model import likelihood
    x, f, g = data
    gp = fitted(x, f, g, "precon")
    lt = torch.log10(gp.hp_vals.theta.detach())
    nll, _, m = ref.nll_and_grad(t(x), t(f), t(g), lt, "precon", 1e10)
    # two factorizations of a matrix of cond ~1e10 round apart by ~1e-9
    assert float(nll) == pytest.approx(-gp.history.ln_lkd[0], rel=1e-8)
    # the gradient away from the optimum, where it is not rounding alone
    lt2 = lt + t([0.3, -0.2, 0.25])
    nll2, grad2, _ = ref.nll_and_grad(t(x), t(f), t(g), lt2, "precon", 1e10)
    val, grad_p, _ = likelihood.neg_mll_and_grad(
        gp.cfg, gp.spec, gp.hp_info_optz_lkd, gp.data, lt2,
        float(gp._etaK))
    assert float(nll2) == pytest.approx(float(val), rel=1e-8)
    torch.testing.assert_close(grad2, grad_p, rtol=1e-6, atol=0.0)
    assert float(m.varK) == pytest.approx(float(gp.hp_vals.varK), rel=1e-8)
    assert float(m.beta[0]) == pytest.approx(float(gp.hp_vals.beta[0]),
                                             rel=1e-8)


def test_rescale_likelihood_in_the_programs_frame(data):
    x, f, g = data
    gp = fitted(x, f, g, "rescale_origin", cond_norm="fro")
    X, F, G = ref.rescaled_frame(t(x), t(f), t(g), t(gp.DataScl.xvec_scale))
    np.testing.assert_allclose(X.numpy(), gp.DataScl.get_scl_x(), rtol=1e-14)
    fs, _, gs, _ = gp.DataScl.get_scl_obj_data()
    np.testing.assert_allclose(F.numpy(), fs, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(G.numpy(), gs, rtol=1e-13, atol=1e-13)
    lt = torch.log10(gp.hp_vals.theta.detach())
    m = ref.Model(X, F, G, lt, "rescale_origin", 1e10)
    assert float(m.varK) == pytest.approx(float(gp.hp_vals.varK), rel=1e-8)
    assert float(m.cond_fro()) <= 1.01e10


def test_predict_and_ei_match(data):
    from gpgradpy_torch.bo import loop
    x, f, g = data
    gp = fitted(x, f, g, "precon")
    m = ref.Model(t(x), t(f), t(g), torch.log10(gp.hp_vals.theta.detach()),
                  "precon", 1e10)
    xq = np.random.default_rng(3).uniform(-2, 2, (6, D))
    got = gp.eval_model(xq, calc_grad=True)[:4]
    want = m.predict(t(xq))
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        # sig cancels 1 - k^T K^-1 k at cond ~1e10
        np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-6 * scale)
    fbest = float(np.min(f))
    acq = loop.acq_objective(gp, "ei", 2.0, fbest)(xq)[0]
    mu, sig = want[0], want[1]
    ei = ref.neg_expected_improvement(mu, sig, fbest).numpy()
    scale = np.abs(fbest - mu.numpy()) + sig.numpy()
    assert np.max(np.abs(acq - ei) / scale) < 1e-7


def test_rescale_loop_frames_are_the_programs(data):
    from gpgradpy_torch import GaussianProcess
    x, f, g = data
    thetas = []
    orig = GaussianProcess._run_fit

    def run_fit(gp, *a, **kw):
        res = orig(gp, *a, **kw)
        thetas.append(t(10.0 ** np.asarray(res.hp_vec, np.float64)))
        return res
    GaussianProcess._run_fit = run_fit
    try:
        gp = fitted(x, f, g, "rescale_origin", cond_norm="fro")
    finally:
        GaussianProcess._run_fit = orig
    assert thetas
    xvec0, xvec_end, theta_end = ref.rescale_loop_frames(t(x), thetas)
    assert ref.min_distance((t(x) - t(x)[-1]) * xvec0) == pytest.approx(
        ref.vreq_rescale(N, D), rel=1e-14)
    np.testing.assert_allclose(gp.DataScl.xvec_scale, xvec_end.numpy(),
                               rtol=1e-13)
    np.testing.assert_allclose(gp.hp_vals.theta.detach().numpy(),
                               theta_end.numpy(), rtol=1e-13)
