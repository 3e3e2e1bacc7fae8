"""Parity of the port's constrained and rescaling fits with the JAX package,
in float64 on the CPU at d=2: the differentiable condition numbers, the
Rescaling frames, the scipy driver's callbacks at fixed hyperparameter
vectors, and facade fits of every conditioning method and scipy optimizer
with their predictions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lkd import hp_vec, problem

import gpgradpy_tpu as jgp
from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_tpu.fit import scipy_driver as jsd
from gpgradpy_tpu.model import assembly as jassembly
from gpgradpy_tpu.model import rescale as jrescale
from gpgradpy_tpu.ops import linalg as jlinalg
import gpgradpy_torch as tgp
from gpgradpy_torch import GaussianProcess, convert
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.fit import scipy_driver as tsd
from gpgradpy_torch.model import assembly as tassembly
from gpgradpy_torch.model import rescale as trescale
from gpgradpy_torch.ops import linalg as tlinalg


def _spd(n, seed, spread=4.0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return Q @ np.diag(np.logspace(0.0, spread, n)) @ Q.T


# ---------------------------------------------------------------------------
# condition numbers
# ---------------------------------------------------------------------------

def test_cond_eigh_batched_value_and_grad_match_jax():
    """A batch of 3 matrices through the port's cond_eigh against jax.grad
    of the JAX cond_eigh, matrix by matrix."""
    A = np.stack([_spd(9, s, spread) for s, spread in ((0, 3.0), (1, 2.0),
                                                       (2, 1.0))])
    At = torch.as_tensor(A).requires_grad_(True)
    val = tlinalg.cond_eigh(At)
    g, = torch.autograd.grad(val.sum(), At)
    for b in range(3):
        v_j, g_j = jax.value_and_grad(jlinalg.cond_eigh)(jnp.asarray(A[b]))
        np.testing.assert_allclose(val[b].item(), float(v_j), rtol=1e-12)
        np.testing.assert_allclose(g[b].numpy(), np.asarray(g_j), rtol=1e-7,
                                   atol=1e-12 * np.max(np.abs(g_j)))


def test_cond_eigh_grad_finite_difference():
    A0 = torch.as_tensor(_spd(9, 3, spread=3.0)).requires_grad_(True)
    D = torch.as_tensor(_spd(9, 4, spread=0.5))
    g, = torch.autograd.grad(tlinalg.cond_eigh(A0), A0)
    eps = 1e-6
    with torch.no_grad():
        fd = (tlinalg.cond_eigh(A0 + eps * D)
              - tlinalg.cond_eigh(A0 - eps * D)) / (2 * eps)
    np.testing.assert_allclose(float((g * D).sum()), float(fd), rtol=1e-5)


def _theta_matrix(theta, X, ns):
    """exp-kernel gram of X plus theta[1] I in either package (ns: jnp or
    torch)."""
    r2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    return ns.exp(-theta[0] * r2) + theta[1] * ns.eye(X.shape[0],
                                                       dtype=X.dtype)


@pytest.mark.parametrize("norm", [2, "fro"])
def test_cond_grad_through_a_parametrized_matrix_matches_jax(norm):
    """d cond / d theta of A(theta) in both norms, autograd against jax.grad
    (the fro norm differentiates through the Cholesky solves)."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-1, 1, (12, 2))
    theta = np.array([0.8, 1e-3])

    def cond_j(th):
        A = _theta_matrix(th, jnp.asarray(X), jnp)
        if norm == 2:
            return jlinalg.cond_eigh(A)
        return jlinalg.cond_fro_w_chol(A, jlinalg.cholesky_ok(A))

    v_j, g_j = jax.value_and_grad(cond_j)(jnp.asarray(theta))
    th = torch.as_tensor(theta).requires_grad_(True)
    A = _theta_matrix(th, torch.as_tensor(X), torch)
    v_t = (tlinalg.cond_eigh(A) if norm == 2
           else tlinalg.cond_fro_w_chol(A, tlinalg.cholesky_ok(A)))
    g_t, = torch.autograd.grad(v_t, th)
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-7)


def test_cond_eigh_non_finite_rows_and_clamped_tiny():
    """A non-finite batch row gets JAX's NaN (value and gradient) without
    reaching torch's eigh, which would raise; the other rows are unchanged.
    An indefinite matrix has w_min clamped at tiny: the value is
    w_max / tiny in both packages, and the port's gradient keeps only the
    v_max term, as JAX's custom VJP intends; JAX's own is NaN there."""
    good = _spd(6, 5, spread=2.0)
    bad = good.copy()
    bad[2, 3] = np.nan
    At = torch.as_tensor(np.stack([good, bad, 2 * good])).requires_grad_(True)
    val = tlinalg.cond_eigh(At)
    g, = torch.autograd.grad(val.sum(), At)
    assert np.isnan(val[1].item()) and torch.isnan(g[1]).all()
    assert float(jlinalg.cond_eigh(jnp.asarray(bad))) != \
        float(jlinalg.cond_eigh(jnp.asarray(bad)))      # NaN in JAX too
    single = tlinalg.cond_eigh(torch.as_tensor(good))
    np.testing.assert_allclose(val[0].item(), single.item(), rtol=1e-14)
    assert torch.isfinite(g[0]).all() and torch.isfinite(g[2]).all()

    w = np.array([-0.5, 0.2, 0.7, 1.3])
    Q, _ = np.linalg.qr(np.random.default_rng(6).standard_normal((4, 4)))
    A = Q @ np.diag(w) @ Q.T
    v_j, g_j = jax.value_and_grad(jlinalg.cond_eigh)(jnp.asarray(A))
    At = torch.as_tensor(A).requires_grad_(True)
    v_t = tlinalg.cond_eigh(At)
    g_t, = torch.autograd.grad(v_t, At)
    tiny = np.finfo(np.float64).tiny
    np.testing.assert_allclose(v_t.item(), 1.3 / tiny, rtol=1e-12)
    np.testing.assert_allclose(v_t.item(), float(v_j), rtol=1e-12)
    v_max = Q[:, -1]
    np.testing.assert_allclose(g_t.numpy(), np.outer(v_max, v_max) / tiny,
                               rtol=1e-9, atol=1e-12 / tiny)
    # JAX multiplies the clamped term by 0 and gets 0 * inf = NaN
    assert np.all(np.isnan(np.asarray(g_j)))


def test_condition_numbers_after_a_failed_cholesky_match_jax():
    """An indefinite M (negative nugget): eigh takes it (w_min clamped, the
    spectral cond overflows to inf in both packages) and under 'fro' the
    identity factor gives ||M||_F sqrt(n) in both."""
    p = problem("SqExp", wellcond="base", n=6)
    v = hp_vec(p)
    j, t = p["j"], p["t"]
    for norm in (2, "fro"):
        ops_t = tassembly.assemble_keta(
            t["cfg"], t["spec"], t["data"],
            tgp.hp_vec_to_hypers(t["info"], torch.as_tensor(v)), -1e-2)
        assert not bool(ops_t.ok)
        c_j = jax.jit(lambda vv: jassembly.calc_cond(jassembly.assemble_keta(
            j["cfg"], j["spec"], j["data"],
            jgp.hp_vec_to_hypers(j["info"], vv), -1e-2), norm))(jnp.asarray(v))
        c_t = tassembly.calc_cond(ops_t, norm)
        np.testing.assert_allclose(c_t.item(), float(c_j), rtol=1e-12)
        if norm == "fro":
            M = ops_t.M.numpy()
            np.testing.assert_allclose(
                c_t.item(), np.linalg.norm(M) * np.sqrt(M.shape[0]),
                rtol=1e-12)
        else:
            assert c_t.item() == np.inf


# ---------------------------------------------------------------------------
# Rescaling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,dist", [("set_vmin", 2.3), ("set_vmax", None),
                                         (None, None)])
def test_rescaling_frames_equal_jax(method, dist):
    rng = np.random.default_rng(3)
    n, d = 7, 3
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    sf, sg = np.full(n, 0.1), np.full((n, d), 0.2)
    nlc = rng.standard_normal((n, 2))
    nlc_g = rng.standard_normal((n, 2, d))
    objs = {}
    for key, mod in (("j", jrescale), ("t", trescale)):
        s = mod.Rescaling(x, x_scl_method=method, dist_set=dist)
        s.set_obj_data(f, sf, g, sg)
        s.set_nlc_data(nlc, None, nlc_g, None)
        objs[key] = s
    xq = rng.uniform(-2, 2, (4, d))
    mu, sig = rng.standard_normal(4), rng.uniform(0.1, 1, 4)
    dmu, dsig = rng.standard_normal((4, d)), rng.standard_normal((4, d))
    d2mu, d2sig = (rng.standard_normal((4, d, d)),
                   rng.standard_normal((4, d, d)))
    A = rng.standard_normal((2, d))
    lb, ub = -np.ones(d), 2 * np.ones(d)
    c_lb, c_ub = np.array([-1.0, 0.5]), np.array([1.0, 3.0])

    def frames(s):
        return ([s.xvec_scale, s.x_shift, s.x_scl, s.obj_shift, s.obj_scale,
                 *s.get_scl_obj_data(), s.nlc_val_scl, s.nlc_grad_scl,
                 s.x_init_2_scl(xq), s.x_scl_2_init(xq),
                 s.dist_init_2_scl(1.7), s.dist_scl_2_init(1.7)]
                + list(s.obj_init_2_scl(mu, sig, dmu, dsig, d2mu, d2sig))
                + list(s.obj_scl_2_init(mu, sig, dmu, dsig, d2mu, d2sig))
                + list(s.boxcon_init_2_scl(lb, ub))
                + list(s.boxcon_scl_2_init(lb, ub))
                + list(s.lincon_init_2_scl(A, c_lb, c_ub)))

    for a, b in zip(frames(objs["t"]), frames(objs["j"])):
        np.testing.assert_array_equal(a, b)
    for s in objs.values():
        s.set_xscale_data(xvec_scale_in=np.array([0.5, 2.0, 1.5]))
    for a, b in zip(frames(objs["t"]), frames(objs["j"])):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the scipy driver's callbacks
# ---------------------------------------------------------------------------

def _memos(p, eta, **cfg_kw):
    out = {}
    for key, make in (("j", jsd._make_callbacks), ("t", tsd._Memo)):
        s = p[key]
        out[key] = make(s["cfg"].replace(**cfg_kw), s["spec"], s["info"],
                        s["data"], eta, True)
    return out


def _ask(m, v, order):
    calls = {"val": m.obj_val, "grad": m.obj_grad, "cond": m.cond,
             "cond_grad": m.cond_grad}
    return {k: np.asarray(calls[k](v), float) for k in order}


@pytest.mark.parametrize("noise", [None, "unknown"])
@pytest.mark.parametrize("norm", [2, "fro"])
@pytest.mark.parametrize("order", [("val", "grad", "cond", "cond_grad"),
                                   ("cond_grad", "cond", "grad", "val")])
def test_callbacks_match_jax(noise, norm, order):
    """The four callbacks at two hp vectors, asked in scipy's order and in
    reverse: values rtol 1e-9, gradients 1e-6, and the same counts of
    MLL / cond evaluations (the lazy memo).  The points have cond <= 1e6:
    two LAPACKs' eigenvalues agree to about cond * 1e-16 relative."""
    p = problem("SqExp", noise=noise, wellcond="base", n=8)
    m = _memos(p, p["eta"], cond_norm=norm)
    for shift in (0.6, 1.0):
        v = hp_vec(p) + shift
        got, want = _ask(m["t"], v, order), _ask(m["j"], v, order)
        for k in order:
            tol = 1e-9 if k in ("val", "cond") else 1e-6
            np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)
    for k in ("n_val", "n_grad", "n_cond", "n_cond_grad", "n_cho_fail"):
        assert getattr(m["t"], k) == getattr(m["j"], k), k


def test_callbacks_failure_ladder_matches_jax():
    """Above cond_max_abs the condition number becomes the objective, with
    its gradient, in both packages.  Where the Cholesky fails (a negative
    nugget makes M indefinite) the values agree: the spectral cond is inf,
    the 'fro' cond ||M||_F sqrt(n).  Neither gradient is usable there: under
    norm 2 both are non-finite, and under 'fro' JAX's is NaN (the VJP of its
    NaN factor) while the port's is finite."""
    p = problem("SqExp", wellcond="base", n=8)
    v = hp_vec(p) + 1.0                   # cond 1.1e5
    m = _memos(p, p["eta"], cond_max_abs=100.0)
    got = _ask(m["t"], v, ("val", "grad", "cond", "cond_grad"))
    want = _ask(m["j"], v, ("val", "grad", "cond", "cond_grad"))
    assert m["t"]._failed and m["j"]._failed and m["t"]._ok
    # the objective is the cond (eigvalsh; the gradient's eigh then
    # overwrites the memo's cond with its own last bits)
    np.testing.assert_allclose(got["val"], got["cond"], rtol=1e-9)
    for k in got:
        tol = 1e-9 if k in ("val", "cond") else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=tol, err_msg=k)

    for norm in (2, "fro"):
        m = _memos(p, -1e-2, cond_norm=norm)
        got = _ask(m["t"], v, ("val", "grad", "cond", "cond_grad"))
        want = _ask(m["j"], v, ("val", "grad", "cond", "cond_grad"))
        assert not m["t"]._ok and m["t"]._failed and m["j"]._failed
        np.testing.assert_allclose(got["val"], want["val"], rtol=1e-9)
        np.testing.assert_allclose(got["cond"], want["cond"], rtol=1e-9)
        if norm == 2:
            assert got["val"] == np.inf
            assert not np.all(np.isfinite(got["grad"]))
            assert not np.all(np.isfinite(want["grad"]))
        else:
            assert np.all(np.isnan(want["grad"]))
            assert np.all(np.isfinite(got["grad"]))
            np.testing.assert_array_equal(got["grad"], got["cond_grad"])
        assert m["t"].n_cho_fail == m["j"].n_cho_fail == 1


# ---------------------------------------------------------------------------
# facade fits
# ---------------------------------------------------------------------------

# name -> (constructor kwargs, data): data = (seed, n, noise)
CASES = {
    "base": (dict(wellcond_mtd="base"), (0, 12, None)),
    "base_fro": (dict(wellcond_mtd="base", cond_norm="fro"), (0, 12, None)),
    "rescale_origin": (dict(wellcond_mtd="rescale_origin", cond_norm="fro"),
                       (0, 12, None)),
    "rescale_eta_vary": (dict(wellcond_mtd="rescale_eta_vary"),
                         (0, 12, None)),
    "dflt_vmin": (dict(wellcond_mtd="dflt_vmin"), (0, 12, None)),
    # on other data the two stop up to 2.5e-6 apart in -ln L (ROADMAP
    # Queue 3, flat optima)
    "dflt_vmax": (dict(wellcond_mtd="dflt_vmax"), (1, 10, None)),
    # trust-constr stops on its trust radius, where round-off decides
    # (THETA_RTOL)
    "trust_constr": (dict(wellcond_mtd="base", optz_mtd="trust-constr",
                          cond_max=1e8, cond_max_target=1e8), (0, 10, None)),
    "precon_slsqp": (dict(wellcond_mtd="precon", optz_mtd="slsqp"),
                     (0, 12, None)),
    "base_noisy": (dict(wellcond_mtd="base"), (1, 12, "unknown")),
    "no_grad": (dict(wellcond_mtd="base", use_grad=False), (0, 12, None)),
}


def _case_data(seed, n, noise, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    if noise:
        f = f + 0.5 * rng.standard_normal(n)
        g = g + 0.5 * rng.standard_normal((n, d))
    xq = rng.uniform(-1.5, 1.5, (5, d))
    return x, f, g, xq


def _facade_fit(cls, name, hp_vals=None, **extra):
    """The case's facade fitted on its data, or set at ``hp_vals``."""
    kw, (seed, n, noise) = CASES[name]
    kw = dict(kw, **extra)
    x, f, g, _ = _case_data(seed, n, noise)
    use_grad = kw.pop("use_grad", True)
    wellcond = kw.pop("wellcond_mtd")
    gp = cls(2, use_grad, "SqExp", wellcond, **kw)
    gp.init_optz_surr(2)
    std = None if noise else np.zeros(n)
    if use_grad:
        gp.set_data(x, f, std, g, None if noise else np.zeros((n, 2)))
    else:
        gp.set_data(x, f, std)
    if hp_vals is None:
        gp.set_hpara("optz", 0)
    else:
        gp.set_hpara("set", 0, hp_vals=hp_vals)
    return gp


@pytest.fixture(scope="module")
def fitted():
    """Each case fitted once per package, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (_facade_fit(GaussianProcess, name, device="cpu"),
                           _facade_fit(JaxGP, name))
        return cache[name]
    return get


def _close(got, want):
    """rtol 1e-3 with a floor of 1e-3 of the largest entry: the flat-optimum
    allowance of test_torch_facade.test_facade_matches_jax."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.max(np.abs(want)))


# theta's rtol where it is not 1e-3: trust-constr stops on its trust radius
# at a point that round-off moves along the likelihood's valley.  Over the
# four BLAS paths of MKL and ATen the port stops 0 to 1.3e-3 from JAX's
# theta, with -ln L 5.8e-7 apart at most (held to 1e-6 below; ROADMAP.md's
# accepted stopping points lie up to 2.5e-6 apart), and the predictions'
# sig gradient moves with the stop, up to 2.5e-3 of its largest entry: in
# these cases the port predicts at the JAX fit's hyperparameters.
THETA_RTOL = {"trust_constr": 5e-3}


@pytest.mark.parametrize("name", list(CASES))
def test_facade_fit_matches_jax(fitted, name):
    """-ln L rtol 1e-6; the condition number at the optimum within
    1.01 cond_max in both; theta (rtol 1e-3, or THETA_RTOL's), the
    rescaling's xvec_scale (so the loop chose the same iteration) and the
    predictions with their gradients rtol 1e-3 (see _close; for the cases
    of THETA_RTOL from the JAX fit's hyperparameters)."""
    gp_t, gp_j = fitted(name)
    h_t, h_j = gp_t.history, gp_j.history
    np.testing.assert_allclose(h_t.ln_lkd[0], h_j.ln_lkd[0], rtol=1e-6)
    if gp_t.b_use_cond_cstr:
        cmax = gp_t.cfg.cond_max
        assert h_t.Kcov_cond[0] <= 1.01 * cmax
        assert h_j.Kcov_cond[0] <= 1.01 * cmax
    np.testing.assert_allclose(h_t.hp_theta[0], h_j.hp_theta[0],
                               rtol=THETA_RTOL.get(name, 1e-3))
    np.testing.assert_allclose(h_t.xvec_rescaling[0], h_j.xvec_rescaling[0],
                               rtol=1e-3)
    np.testing.assert_array_equal(h_t.vmin_req_grad, h_j.vmin_req_grad)
    xq = _case_data(*CASES[name][1])[3]
    if name in THETA_RTOL:
        gp_t = _facade_fit(GaussianProcess, name, device="cpu",
                           hp_vals=convert.hypers_from_numpy(
                               {k: None if v is None else np.asarray(v)
                                for k, v in gp_j.hp_vals._asdict().items()},
                               device="cpu"))
    for got, want in zip(gp_t.eval_model(xq, calc_grad=True),
                         gp_j.eval_model(xq, calc_grad=True)):
        if want is not None:
            _close(got, want)
    for got, want in zip(gp_t.eval_model_var(xq, calc_grad=True),
                         gp_j.eval_model_var(xq, calc_grad=True)):
        if want is not None:
            _close(got, want)


def test_rescale_loop_telemetry_and_frames(fitted):
    """The rescale loop ran its inner fits (warm-started after the first)
    and left the data in the scaled frame; the frame accessors map to and
    from it as the JAX facade's do."""
    gp_t, gp_j = fitted("rescale_origin")
    assert 1 <= len(gp_t.optz_infos) <= gp_t.cfg.cond_vreq_max_iter
    for info in gp_t.optz_infos:
        assert {"optz_n_val", "optz_n_grad", "optz_n_cond",
                "optz_n_cond_grad"} <= set(info)
    x = gp_t._x_eval_in
    np.testing.assert_allclose(gp_t.x_init_2_scl(x), gp_j.x_init_2_scl(x),
                               rtol=1e-3)
    np.testing.assert_allclose(gp_t.x_scl_2_init(gp_t.x_init_2_scl(x)), x,
                               rtol=1e-12)
    np.testing.assert_allclose(gp_t.get_scl_x_w_dist()[0],
                               gp_t.x_init_2_scl(x), rtol=1e-12)
    for a, b in zip(gp_t.get_scl_eval_data(), gp_j.get_scl_eval_data()):
        if b is not None:
            np.testing.assert_allclose(a, b, rtol=1e-3)
    for a, b in zip(gp_t.get_init_eval_data(), gp_j.get_init_eval_data()):
        if b is not None:
            np.testing.assert_array_equal(a, b)


def test_telemetry_keys_match_jax():
    """fit_map_scipy's telemetry has the JAX driver's keys and counts the
    same Cholesky failures on the same fit."""
    p = problem("SqExp", wellcond="base", n=8)
    res = {}
    for key, mod in (("j", jsd), ("t", tsd)):
        s = p[key]
        res[key] = mod.fit_map_scipy(s["cfg"], s["spec"], s["info"],
                                     s["data"], p["eta"])
    assert set(res["t"].info) == set(res["j"].info)
    np.testing.assert_allclose(res["t"].neg_lkd, float(res["j"].neg_lkd),
                               rtol=1e-6)
    assert res["t"].info["optz_n_cho_fail"] == res["j"].info["optz_n_cho_fail"]


def test_none_is_base_and_float32_base_fits():
    """wellcond_mtd=None is 'base'.  A float32 model is evaluated in
    float32 (scipy's float64 iterate is rounded to it): its base fit runs
    and keeps the constraint."""
    assert GaussianProcess(2, True, "SqExp", None,
                           device="cpu").cfg.wellcond_mtd == "base"
    gp = _facade_fit(GaussianProcess, "base", device="cpu", dtype="float32",
                     cond_max=1e6, cond_max_target=1e6)
    assert gp.data.x.dtype == torch.float32
    assert np.isfinite(gp.history.ln_lkd[0])
    assert gp.history.Kcov_cond[0] <= 1.01 * 1e6
    xq = _case_data(*CASES["base"][1])[3]
    out = gp.eval_model(xq, calc_grad=True)
    assert out[0].dtype == np.float32
    assert all(np.all(np.isfinite(a)) for a in out[:4])


@pytest.mark.parametrize("wellcond,pad", [("rescale_origin", 0),
                                          ("precon", 4)])
def test_get_init_hp_vals_reads_the_working_frame(wellcond, pad):
    """get_init_hp_vals takes beta[0] from the working frame's values: the
    scaled ones under a rescaling, and with padding the padded vector (its
    zeros averaged in, as the JAX package does); the whole training round
    at n_eval <= hp_const_n_eval matches JAX."""
    x, f, g, xq = _case_data(0, 3, None)
    gps = []
    for cls, kw in ((GaussianProcess, dict(device="cpu")), (JaxGP, {})):
        gp = cls(2, True, "SqExp", wellcond, hp_const_n_eval=3,
                 pad_n_eval_multiple=pad, **kw)
        gp.init_optz_surr(1)
        gp.set_data(x, f, np.zeros(3), g, np.zeros((3, 2)))
        gps.append(gp)
    hp_t, hp_j = gps[0].get_init_hp_vals(), gps[1].get_init_hp_vals()
    want_f = gps[1].data.fval
    np.testing.assert_allclose(hp_t.beta.numpy(), [np.mean(want_f)],
                               rtol=1e-14)
    np.testing.assert_allclose(hp_t.beta.numpy(), np.asarray(hp_j.beta),
                               rtol=1e-14)
    assert hp_t.beta.item() != np.mean(f)
    for gp in gps:
        gp.set_hpara("optz", 0)
    np.testing.assert_allclose(gps[0].history.Kcov_cond[0],
                               gps[1].history.Kcov_cond[0], rtol=1e-6)
    # equal hyperparameters: the tolerances of test_torch_fit_predict
    for got, want in zip(gps[0].eval_model(xq), gps[1].eval_model(xq)):
        if want is not None:
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=1e-8,
                                       atol=1e-8 * np.max(np.abs(want)))
