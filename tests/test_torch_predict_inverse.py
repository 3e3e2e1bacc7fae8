"""The predict's solve against a kept triangular inverse
(``model/predict.PredictGraphs.build_inverse`` and ``predict._solve``).

On the card the first capture of a float64 state keeps L^-1 of its factor,
and every query of the state then solves through it: two matrix products
and one step of refinement against M.  On the CPU no query builds it;
these tests build it through the same helper, under ``precon``,
``rescale_origin`` and a padded partial gradient set at d=3 and d=10, for
every flag and both bodies, and hold the state's outputs (each as its
largest gap over its largest value) to two references:

- the factor-solve body (the arithmetic of a state without the inverse),
  to 1e-7.  The readings: <= 3.5e-14 at d=10; at d=3, where the fitted
  models reach cond(M) ~6e9, <= 3.5e-8, the two paths' own rounding (each
  is up to 3.5e-8 from the long-double solve below).  Without the
  refinement step the gap reads up to 8.3e-7 there.
- a solve refined with residuals in long double: the inverse's error is
  at most 4 times the factor solve's, plus 1e-13 (readings: <= 2.5 times;
  <= 3.3e-14 at d=10).

An f32 factor and the refined predict keep no inverse.
"""

import numpy as np
import pytest

from gpgradpy_torch.model import predict
from test_torch_predict_graph import FLAGS, _accurate_solve, _fit, _query, _rel

MODELS = {
    "precon": dict(),
    "rescale_origin": dict(wellcond="rescale_origin", cond_norm="fro"),
    "padded-partial": dict(pad_n_eval_multiple=16,
                           bvec=np.arange(20) % 3 != 1),
}
BODIES = (predict._eval_model, predict._eval_model_var)


def _with_inverse(gp):
    """The facade's state, and a copy that keeps the inverse of the same
    factor, built as the first capture on the card builds it."""
    state = gp._eval_state
    inv = state._replace(graphs=predict.PredictGraphs())
    inv.graphs.build_inverse(inv.ops)
    return state, inv


def _outputs(gp, state, m, seed):
    """Every output of both bodies at m query points, for every flag."""
    xq = _query(gp, m, seed)
    return [v for body in BODIES for calc_grad, calc_hess in FLAGS
            for v in body(gp.cfg_predict, gp.spec, gp.data, state, xq,
                          calc_grad, calc_hess)]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("d", [3, 10])
def test_inverse_solve_equals_factor_solve(d, name, monkeypatch):
    gp = _fit(d, 20, device="cpu", **MODELS[name])
    state, inv = _with_inverse(gp)
    n = gp.spec.n_data_tot
    assert inv.graphs.linv.shape == (n, n)
    assert predict.graph_counts(inv)["inverse_builds"] == 1
    inv.graphs.build_inverse(inv.ops)            # kept: no second build
    assert predict.graph_counts(inv)["inverse_builds"] == 1
    gap = err_inv = err_fac = 0.0
    for m in (1, 4, 17):
        fac = _outputs(gp, state, m, 200 + m)
        got = _outputs(gp, inv, m, 200 + m)
        with monkeypatch.context() as mp:
            mp.setattr(predict, "_ops_solve", _accurate_solve)
            ref = _outputs(gp, state, m, 200 + m)
        for g, f, r in zip(got, fac, ref):
            gap = max(gap, _rel(g, f))
            err_inv, err_fac = max(err_inv, _rel(g, r)), max(err_fac, _rel(f, r))
    assert gap <= 1e-7, gap
    assert err_inv <= 4.0 * err_fac + 1e-13, (err_inv, err_fac)
    # the facade's own state queried on the CPU keeps no inverse
    gp.eval_model(np.zeros((2, d)), calc_grad=True)
    assert state.graphs.linv is None
    assert predict.graph_counts(state)["inverse_builds"] == 0


@pytest.mark.parametrize("kw", [
    dict(dtype="float32", cond_max_target=1e6),
    dict(dtype="float32", n_refine_predict=2, cond_max_target=1e6),
], ids=["f32", "refined"])
def test_no_inverse_for_a_lower_precision_factor(kw):
    gp = _fit(3, 12, device="cpu", **kw)
    state, inv = _with_inverse(gp)
    assert inv.ops.fac.L.dtype.itemsize == 4
    assert inv.graphs.linv is None
    assert predict.graph_counts(inv)["inverse_builds"] == 0
    xq = _query(gp, 3, 5)
    for body in BODIES:
        want = body(gp.cfg_predict, gp.spec, gp.data, state, xq, True, True)
        got = body(gp.cfg_predict, gp.spec, gp.data, inv, xq, True, True)
        for g, w in zip(got, want):
            assert _rel(g, w) == 0.0
