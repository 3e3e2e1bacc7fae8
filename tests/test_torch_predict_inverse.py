"""The predict's solve of a state, chosen once (``model/predict.
choose_solve``), and the solve against a triangular inverse
(``predict.InverseSolve``).

On the card a float64 state solves every query through the inverse of its
factor, built on its first query: two matrix products and one step of
refinement against M.  The CPU states keep the factor solves; these tests
give a state's copy an ``InverseSolve`` of the same factor, under
``precon``, ``rescale_origin`` and a padded partial gradient set at d=3 and
d=10, for every flag and both bodies, and hold its outputs (each as its
largest gap over its largest value) to two references, in units of
eps cond(M), the scale of a backward-stable solve's forward error (eps =
2.2e-16; cond(M) ~5e9 at d=3, 4e3-1e4 at d=10):

- a solve refined with residuals in long double: the inverse's error at
  most 0.1.  Readings over the four BLAS paths of MKL and ATen at 1 and 4
  threads: <= 0.045 (the factor solve's own: <= 0.09); without the
  refinement step up to 0.96.
- the factor-solve body (the arithmetic of a state without the inverse):
  at most 0.25, the two solves' errors together (readings <= 0.105, which
  is 1.3e-7 relative at d=3).

The rule: the dtypes of the factor and of M, the device and the refined
predict decide the solve; an f32 factor and the refined predict keep no
inverse.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

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
    """The facade's state, and a copy with its own counter that solves
    through the inverse of the same factor, as a float64 state does on the
    card."""
    state = gp._eval_state
    graphs = predict.PredictGraphs()
    inv = state._replace(graphs=graphs,
                         solve=predict.InverseSolve(state.ops, graphs.counts))
    return state, inv


def _outputs(gp, state, m, seed):
    """Every output of both bodies at m query points, for every flag."""
    xq = _query(gp, m, seed)
    return [v for body in BODIES for calc_grad, calc_hess in FLAGS
            for v in body(gp.cfg_predict, gp.spec, gp.data, state, xq,
                          calc_grad, calc_hess)]


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("d", [3, 10])
def test_inverse_solve_equals_factor_solve(d, name):
    gp = _fit(d, 20, device="cpu", **MODELS[name])
    state, inv = _with_inverse(gp)
    n = gp.spec.n_data_tot
    assert predict.graph_counts(inv)["inverse_builds"] == 0   # built lazily
    accurate = state._replace(
        solve=functools.partial(_accurate_solve, state.ops))
    gap = err_inv = 0.0
    for m in (1, 4, 17):
        fac = _outputs(gp, state, m, 200 + m)
        got = _outputs(gp, inv, m, 200 + m)
        ref = _outputs(gp, accurate, m, 200 + m)
        for g, f, r in zip(got, fac, ref):
            gap, err_inv = max(gap, _rel(g, f)), max(err_inv, _rel(g, r))
    assert inv.solve.linv.shape == (n, n)
    assert predict.graph_counts(inv)["inverse_builds"] == 1   # kept
    unit = torch.finfo(torch.float64).eps * float(
        torch.linalg.cond(state.ops.M))
    assert err_inv <= 0.1 * unit, err_inv / unit
    assert gap <= 0.25 * unit, gap / unit
    # the facade's own state queried on the CPU keeps no inverse
    gp.eval_model(np.zeros((2, d)), calc_grad=True)
    assert state.solve == state.ops.solve
    assert predict.graph_counts(state)["inverse_builds"] == 0


def _factor_on(device, L_dtype, M_dtype):
    """A stand-in for a state's KetaOps: what choose_solve reads of it."""
    return SimpleNamespace(
        fac=SimpleNamespace(L=SimpleNamespace(dtype=L_dtype,
                                              device=torch.device(device))),
        M=SimpleNamespace(dtype=M_dtype), solve=object())


F64, F32 = torch.float64, torch.float32


@pytest.mark.parametrize("device, L_dtype, M_dtype, n_refine, want", [
    ("cuda", F64, F64, 0, "inverse"),
    ("cpu", F64, F64, 0, "factor"),
    ("cuda", F32, F32, 0, "factor"),
    ("cuda", F32, F64, 2, "refined"),
    ("cpu", F32, F64, 2, "refined"),
])
def test_choose_solve_by_dtype_device_and_refinement(device, L_dtype,
                                                     M_dtype, n_refine, want):
    ops = _factor_on(device, L_dtype, M_dtype)
    counts = {"inverse_builds": 0}
    solve = predict.choose_solve(SimpleNamespace(n_refine_predict=n_refine),
                                 ops, counts)
    got = ("inverse" if isinstance(solve, predict.InverseSolve)
           else "factor" if solve is ops.solve
           else "refined" if (isinstance(solve, functools.partial)
                              and solve.func is predict._refined_solve
                              and solve.args == (ops, n_refine)) else solve)
    assert got == want
    assert counts["inverse_builds"] == 0      # nothing built at the choice


@pytest.mark.parametrize("kw", [
    dict(dtype="float32", cond_max_target=1e6),
    dict(dtype="float32", n_refine_predict=2, cond_max_target=1e6),
], ids=["f32", "refined"])
def test_no_inverse_for_a_lower_precision_factor(kw):
    """A state whose factor is f32 chooses the same solve on the card as
    here, none through an inverse, and answers every query bitwise as a
    state given that solve anew."""
    gp = _fit(3, 12, device="cpu", **kw)
    state = gp._eval_state
    ops, cfg = state.ops, gp.cfg_predict
    assert ops.fac.L.dtype.itemsize == 4
    L = ops.fac.L
    on_card = ops._replace(fac=SimpleNamespace(
        L=SimpleNamespace(dtype=L.dtype, device=torch.device("cuda"))))
    card = predict.choose_solve(cfg, on_card, {})
    assert not isinstance(card, predict.InverseSolve)
    assert not isinstance(state.solve, predict.InverseSolve)
    refined = isinstance(card, functools.partial)
    assert refined == bool(kw.get("n_refine_predict"))
    assert refined == isinstance(state.solve, functools.partial)
    again = state._replace(graphs=predict.PredictGraphs(),
                           solve=predict.choose_solve(cfg, ops, {}))
    xq = _query(gp, 3, 5)
    for body in BODIES:
        want = body(cfg, gp.spec, gp.data, state, xq, True, True)
        got = body(cfg, gp.spec, gp.data, again, xq, True, True)
        for g, w in zip(got, want):
            assert _rel(g, w) == 0.0
    assert predict.graph_counts(state)["inverse_builds"] == 0
