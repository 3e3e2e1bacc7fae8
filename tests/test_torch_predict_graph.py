"""The predict's CUDA graphs (``model/predict.PredictGraphs``).

On the CPU: the counter reports only eager calls, and the cross covariance
built with a state's precomputed pad mask and gradient index equals the
one built per call and the plain gradient-enhanced cross kernel.

On the card (marked ``card``, skipped without a CUDA device): the graphed
predict equals its eager body at d=10 for every row count the acquisition
sends (1-17), with and without gradients and Hessians, for eval_model and
eval_model_var, under ``precon``, ``rescale_origin``, a padded partial
gradient set and the refined predict; a call's results survive the next
call; the counter shows one capture per key and replays after it, and a
new state starts a fresh count.  The graphed predict, which solves through
the inverse of the factor that a float64 state builds on its first query,
stays within the factor solves' own rounding, also at N 1771; an eager
query answers the same before and after a graphed one.

    python -m pytest tests/test_torch_predict_graph.py -q -m card
"""

import functools

import numpy as np
import pytest
import torch

from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.bo import loop
from gpgradpy_torch.model import predict
from gpgradpy_torch.ops import kernels, rtensor


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def _rosen(x):
    a = 10.0
    f = np.sum(a * (x[:, 1:] - x[:, :-1] ** 2) ** 2
               + (1.0 - x[:, :-1]) ** 2, axis=1)
    g = np.zeros_like(x)
    g[:, :-1] = (-4.0 * a * x[:, :-1] * (x[:, 1:] - x[:, :-1] ** 2)
                 - 2.0 * (1.0 - x[:, :-1]))
    g[:, 1:] += 2.0 * a * (x[:, 1:] - x[:, :-1] ** 2)
    return f, g


def _fit(d, n, wellcond="precon", bvec=None, seed=0, **kw):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, (n, d))
    f, g = _rosen(x)
    if bvec is not None:
        g = g[bvec]                     # the gradients of the points in bvec
    gp = GaussianProcess(d, True, "SqExp", wellcond, **kw)
    gp.init_optz_surr(1)
    gp.set_data(x, f, np.zeros(n), g, np.zeros_like(g), bvec_use_grad=bvec)
    gp.set_hpara("optz", 0)
    return gp


def _query(gp, m, seed):
    """m points near the data, in the working frame, on the model's
    device and in the predict's dtype."""
    rng = np.random.default_rng(seed)
    x = gp.x_init_2_scl(rng.uniform(-2.0, 2.0, (m, gp.cfg.dim)))
    return torch.as_tensor(x, dtype=gp._predict_dtype, device=gp.device)


def _args(gp):
    return gp.cfg_predict, gp.spec, gp.data, gp._eval_state


def _accurate_solve(ops, b):
    """Keta^-1 b refined to the rounding of long double (80-bit on
    x86-64): factor solves of residuals taken in long double on the host;
    on b's device.  A state's solve: ``functools.partial(_accurate_solve,
    ops)``."""
    L = ops.fac.L.cpu().double()
    M = ops.M.cpu().numpy().astype(np.longdouble)
    p = ops.pvec.cpu().numpy().astype(np.longdouble)[:, None]
    rhs = b.cpu().numpy().astype(np.longdouble) / p
    y = np.zeros_like(rhs)
    for _ in range(4):
        r = torch.as_tensor((rhs - M @ y).astype(np.float64))
        y = y + torch.cholesky_solve(r, L).numpy().astype(np.longdouble)
    return torch.as_tensor((y / p).astype(np.float64), device=b.device)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wellcond", ["precon", "rescale_origin"])
def test_cpu_counter_reports_only_eager_calls(wellcond):
    kw = dict(cond_norm="fro") if wellcond == "rescale_origin" else {}
    gp = _fit(2, 8, wellcond, device="cpu", **kw)
    state = gp._eval_state
    assert predict.graph_counts(state) == {"captures": 0, "replays": 0,
                                           "eager": 0, "inverse_builds": 0}
    x = np.random.default_rng(1).uniform(-2.0, 2.0, (3, 2))
    gp.eval_model(x, calc_grad=True)
    gp.eval_model(x, calc_grad=True, calc_hess=True)
    gp.eval_model_var(x[:1], calc_grad=True)
    if wellcond == "precon":
        gp.make_predict_fn(calc_grad=True)(x)
    xs = gp.x_init_2_scl(x)
    loop.acq_objective(gp, "ei", 2.0, 1.0)(xs)
    n = 5 if wellcond == "precon" else 4
    assert predict.graph_counts(state) == {"captures": 0, "replays": 0,
                                           "eager": n, "inverse_builds": 0}


def test_to_host_equals_a_copy_of_each_output():
    gp = _fit(2, 8, device="cpu")
    xq = _query(gp, 4, 2)
    for fn in (predict.eval_model, predict.eval_model_var):
        for calc_grad, calc_hess in ((False, False), (True, True)):
            out = fn(*_args(gp), xq, calc_grad, calc_hess)
            got = predict.to_host(out)
            assert len(got) == len(out)
            for g, w in zip(got, out):
                if w is None:
                    assert g is None
                else:
                    assert isinstance(g, np.ndarray)
                    np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("pad, partial", [(8, False), (0, True), (8, True)])
def test_cross_cov_with_state_tensors_equals_per_call(pad, partial):
    d, n = 3, 11
    bvec = (np.arange(n) % 3 != 1) if partial else None
    gp = _fit(d, n, bvec=bvec, device="cpu", pad_n_eval_multiple=pad)
    cfg, spec, data, state = _args(gp)
    assert (state.pad_mask is not None) == bool(pad)
    assert (state.idx_grad is not None) == (pad > 0 or partial)
    xq = _query(gp, 5, 3)
    hp = state.hp
    got = predict.cross_cov(cfg, spec, data.x, xq, hp, state.pad_mask,
                            state.idx_grad)
    fresh = predict.cross_cov(cfg, spec, data.x, xq, hp,
                              *predict.spec_tensors(spec, data.x))
    for g, f in zip(got, fresh):
        torch.testing.assert_close(g, f, rtol=0, atol=0)
    # the plain gradient-enhanced cross kernel: rows the training data
    # (values, then the used gradients grouped by dim), columns the query
    # values, then the query gradients grouped by dim; padding rows zeroed
    K = kernels.kern_grad(cfg.kernel_type, rtensor.calc_rtensor(data.x, xq),
                          hp.theta, hp.kernel, idx_g1=spec.idx_grad_arr)
    if spec.pad_mask() is not None:
        K = K * torch.as_tensor(spec.pad_mask())[:, None]
    Kyx, dKxy_dx = got
    nq = xq.shape[0]
    torch.testing.assert_close(Kyx, K[:, :nq], rtol=1e-13, atol=1e-15)
    torch.testing.assert_close(dKxy_dx, K[:, nq:].T, rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

MODELS = {
    "precon": dict(),
    "rescale_origin": dict(wellcond="rescale_origin", cond_norm="fro"),
    "padded-partial": dict(pad_n_eval_multiple=16,
                           bvec=np.arange(30) % 3 != 1),
    "refined": dict(dtype="float32", n_refine_predict=2,
                    cond_max_target=1e6),
}


# n_eval of a model where it is not 30 (N = 11 n_eval): the size of the
# benchmark's predict cell, as a precon model
N_EVAL = {"precon-1771": 161}


@pytest.fixture(scope="module")
def models():
    return {}


def _model(models, name):
    if name not in models:
        models[name] = _fit(10, N_EVAL.get(name, 30), **MODELS.get(name, {}))
    return models[name]


def _rel(got, want):
    if want is None:
        assert got is None
        return 0.0
    top = float(want.abs().max())
    return float((got - want).abs().max()) / max(top, 1e-300)


FLAGS = [(False, False), (True, False), (True, True)]


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_equals_eager_on_the_card(card, models, name):
    gp = _model(models, name)
    args = _args(gp)
    worst = 0.0
    with torch.no_grad():
        for m in range(1, 18):
            xq = _query(gp, m, 100 + m)
            for calc_grad, calc_hess in FLAGS:
                for fn, body in ((predict.eval_model, predict._eval_model),
                                 (predict.eval_model_var,
                                  predict._eval_model_var)):
                    got = fn(*args, xq, calc_grad, calc_hess)
                    want = body(*args, xq, calc_grad, calc_hess)
                    for g, w in zip(got, want):
                        worst = max(worst, _rel(g, w))
    counts = predict.graph_counts(gp._eval_state)
    assert counts["eager"] == 0 and counts["captures"] > 0
    assert worst <= 1e-14, worst
    # the facade (its frame scaling on the host) against the eager body
    x = np.random.default_rng(7).uniform(-2.0, 2.0, (5, 10))
    got = gp.eval_model(x, calc_grad=True, calc_hess=True)
    with torch.no_grad():
        want = predict._eval_model(*args, _query_init(gp, x), True, True)
    want = [v.cpu().numpy() for v in want]
    if gp.DataScl is not None:
        want = gp.DataScl.obj_scl_2_init(*want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-14,
                                   atol=1e-14 * np.abs(w).max())


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(MODELS) + sorted(N_EVAL))
def test_inverse_solve_equals_factor_solve_on_the_card(card, models, name):
    """The graphed predict of a float64 state, which solves through the
    inverse its first query built, against the eager body of the same
    state without it (the factor solves), each output as its largest gap
    over its largest value, m 1-17, every flag, both bodies: <= 1e-7, the
    two paths' own rounding (the card's one cuBLAS path reads <= 1.6e-8;
    tests/test_torch_predict_inverse.py holds the CPU's several BLAS paths
    in units of eps cond(M)).  And mu, sig and their gradients against a
    solve refined in long double: the inverse's error at most 4 times the
    factor solve's, plus 1e-13.  The refined predict keeps no inverse."""
    gp = _model(models, name)
    cfg, spec, data, state = _args(gp)
    factor = state._replace(
        graphs=predict.PredictGraphs(),
        solve=(state.ops.solve if isinstance(state.solve, predict.InverseSolve)
               else state.solve))
    accurate = factor._replace(
        solve=functools.partial(_accurate_solve, state.ops))
    gap = err_inv = err_fac = 0.0
    with torch.no_grad():
        for m in range(1, 18):
            xq = _query(gp, m, 300 + m)
            for calc_grad, calc_hess in FLAGS:
                for fn, body in ((predict.eval_model, predict._eval_model),
                                 (predict.eval_model_var,
                                  predict._eval_model_var)):
                    got = fn(cfg, spec, data, state, xq, calc_grad, calc_hess)
                    want = body(cfg, spec, data, factor, xq, calc_grad,
                                calc_hess)
                    for g, w in zip(got, want):
                        gap = max(gap, _rel(g, w))
            got = predict.eval_model(cfg, spec, data, state, xq, True)
            fac = predict._eval_model(cfg, spec, data, factor, xq, True, False)
            ref = predict._eval_model(cfg, spec, data, accurate, xq, True,
                                      False)
            for g, f, r in zip(got, fac, ref):
                err_inv = max(err_inv, _rel(g, r))
                err_fac = max(err_fac, _rel(f, r))
    builds = predict.graph_counts(state)["inverse_builds"]
    print(f"[inverse] {name} N {spec.n_data_tot} inverse_builds {builds} "
          f"gap {gap:.3e} error: inverse {err_inv:.3e} factor {err_fac:.3e}")
    assert builds == (0 if name == "refined" else 1)
    assert isinstance(state.solve, predict.InverseSolve) == (name != "refined")
    assert gap <= 1e-7, gap
    assert err_inv <= 4.0 * err_fac + 1e-13, (err_inv, err_fac)


def _query_init(gp, x):
    return torch.as_tensor(gp.x_init_2_scl(x), dtype=gp._predict_dtype,
                           device=gp.device)


@pytest.mark.card
def test_results_survive_the_next_call_on_the_card(card, models):
    gp = _model(models, "precon")
    args = _args(gp)
    x1, x2 = _query(gp, 4, 11), _query(gp, 4, 12)
    with torch.no_grad():
        first = predict.eval_model(*args, x1, calc_grad=True)[:4]
        kept = [v.clone() for v in first]
        host = gp.eval_model(x1.cpu().numpy(), calc_grad=True)[:4]
        host_kept = [v.copy() for v in host]
        second = predict.eval_model(*args, x2, calc_grad=True)
        gp.eval_model(x2.cpu().numpy(), calc_grad=True)
        fn = gp.make_predict_fn(calc_grad=True)
        served = fn(x1)[:4]
        served_kept = [v.clone() for v in served]
        fn(x2)
    assert not torch.equal(first[0], second[0])
    for a, b in zip(first, kept):
        assert torch.equal(a, b)
    for a, b in zip(host, host_kept):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(served, served_kept):
        assert torch.equal(a, b)


@pytest.mark.card
def test_eager_answer_is_the_same_before_and_after_a_graph(card, models):
    """A state's solve is chosen once: an eager query (autograd on) gives
    bitwise the same answer before the state's first graphed query and
    after it, and the state builds its inverse once."""
    gp = _model(models, "precon")
    gp.set_hpara("current", 0)          # a fresh state
    args = _args(gp)
    xq = _query(gp, 3, 21)

    def eager():
        with torch.enable_grad():
            return [v.detach().clone()
                    for v in predict.eval_model(*args, xq, True, True)]
    before = eager()
    with torch.no_grad():
        predict.eval_model(*args, xq, True, True)
    after = eager()
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    assert predict.graph_counts(gp._eval_state) == {
        "captures": 1, "replays": 0, "eager": 2, "inverse_builds": 1}


@pytest.mark.card
def test_counter_captures_once_per_key_on_the_card(card, models):
    gp = _model(models, "precon")
    gp.set_hpara("current", 0)          # a fresh state
    state = gp._eval_state
    assert predict.graph_counts(state) == {"captures": 0, "replays": 0,
                                           "eager": 0, "inverse_builds": 0}
    x3 = np.random.default_rng(3).uniform(-2.0, 2.0, (3, 10))
    for _ in range(4):
        gp.eval_model(x3, calc_grad=True)
    assert predict.graph_counts(state) == {"captures": 1, "replays": 3,
                                           "eager": 0, "inverse_builds": 1}
    gp.eval_model(x3[:2], calc_grad=True)         # another row count
    gp.eval_model(x3, calc_grad=False)            # another flag
    gp.eval_model_var(x3, calc_grad=True)         # another variant
    gp.eval_model(x3, calc_grad=True)
    assert predict.graph_counts(state) == {"captures": 4, "replays": 4,
                                           "eager": 0, "inverse_builds": 1}
    with torch.enable_grad():                     # autograd on: eager
        predict.eval_model(*_args(gp), _query(gp, 3, 4), calc_grad=True)
    assert predict.graph_counts(state)["eager"] == 1
    gp.set_hpara("current", 0)
    assert gp._eval_state is not state
    assert predict.graph_counts(gp._eval_state) == {"captures": 0,
                                                    "replays": 0, "eager": 0,
                                                    "inverse_builds": 0}
