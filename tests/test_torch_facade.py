"""The port's GaussianProcess facade end to end on the CPU, against the JAX
package's facade (float64), plus the port's contracts: the device rule,
the options not ported yet, 'base', float32, padding, history, and a
package that imports nothing of JAX."""

import ast
import importlib
import pathlib
import pkgutil
import re

import numpy as np
import pytest
import torch

from gpgradpy_tpu import GaussianProcess as JaxGP
from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.bo.problems import rosenbrock

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _data(n=12, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    xq = rng.uniform(-1.5, 1.5, (5, d))
    return x, f, g, xq


def _fit(cls, d, x, f, g, ktype="SqExp", wellcond="precon", **kw):
    gp = cls(d, True, ktype, wellcond, **kw)
    gp.init_optz_surr(2)
    n = x.shape[0]
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
    gp.set_hpara("optz", 0)
    return gp


@pytest.mark.parametrize("ktype", ["SqExp", "RatQu"])
def test_facade_matches_jax(ktype):
    """d=2, n_eval=12 Rosenbrock: the same -ln L (rtol 1e-6), then the
    hyperparameters and predictions.  The likelihood is flat near its
    optimum: the two optimizers stop on tol_f 1e-12 at -ln L 2e-10 apart but
    theta 2e-5 apart, which moves the std gradients by ~2e-4 of their
    largest entry.  So hyperparameters and predictions get rtol 1e-3 with a
    floor of 1e-3 of each output's largest entry; parity at equal
    hyperparameters is held to 1e-8 in test_torch_fit_predict."""
    x, f, g, xq = _data()
    gp_t = _fit(GaussianProcess, 2, x, f, g, ktype, device="cpu")
    gp_j = _fit(JaxGP, 2, x, f, g, ktype)
    np.testing.assert_allclose(gp_t.history.ln_lkd[0], gp_j.history.ln_lkd[0],
                               rtol=1e-6)
    np.testing.assert_allclose(gp_t.history.hp_theta[0],
                               gp_j.history.hp_theta[0], rtol=1e-3)
    for got, want in zip(gp_t.eval_model(xq, calc_grad=True, calc_hess=True),
                         gp_j.eval_model(xq, calc_grad=True, calc_hess=True)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-3 * np.max(np.abs(want)))
    for got, want in zip(gp_t.eval_model_var(xq, calc_grad=True),
                         gp_j.eval_model_var(xq, calc_grad=True)):
        if want is not None:
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                       atol=1e-3 * np.max(np.abs(want)))


def test_facade_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GaussianProcess(2, True)


@pytest.mark.parametrize("option", [
    dict(solver="iterative", iter_use_mesh=True), dict(solver="dense_dist"),
    dict(solver="dense_dist", wellcond_mtd="base"),
    dict(solver="iterative", iter_use_mesh=True, wellcond_mtd="base")])
def test_options_of_later_slices_raise(option):
    """The multi-device options are ported: they raise only as every entry
    point does, without a card unless the CPU is asked for, and where the
    JAX package refuses them too (dense_dist fits 'precon' only)."""
    kw = dict(option)
    wellcond = kw.pop("wellcond_mtd", "precon")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GaussianProcess(2, True, "SqExp", wellcond, **kw)
    gp = GaussianProcess(2, True, "SqExp", wellcond, device="cpu", **kw)
    assert all(getattr(gp.cfg, k) == v for k, v in kw.items())
    if kw["solver"] == "dense_dist" and wellcond == "base":
        x, f, g, _ = _data(n=6)
        gp.init_optz_surr(2)
        gp.set_data(x, f, np.zeros(6), g, np.zeros_like(g))
        with pytest.raises(ValueError, match="precon"):
            gp.set_hpara("optz", 0)


def test_base_method_float32_and_padding():
    """'base' (also reached by wellcond_mtd=None) fits with SLSQP under the
    condition-number constraint, as in the JAX package, to the same -ln L;
    'precon' fits and interpolates the data; float32 runs end to end;
    padding the dataset leaves the fit and the predictions unchanged."""
    x, f, g, xq = _data(n=10)
    gp_j = _fit(JaxGP, 2, x, f, g, "SqExp", "base")
    for wellcond in ("base", None):
        gp_b = _fit(GaussianProcess, 2, x, f, g, "SqExp", wellcond,
                    device="cpu")
        np.testing.assert_allclose(gp_b.history.ln_lkd[0],
                                   gp_j.history.ln_lkd[0], rtol=1e-6)
        assert gp_b.history.Kcov_cond[0] <= 1.01 * gp_b.cfg.cond_max


    gp_0 = _fit(GaussianProcess, 2, x, f, g, device="cpu")
    assert np.isfinite(gp_0.history.ln_lkd[0])
    np.testing.assert_allclose(gp_0.eval_model(x)[0], f,
                               atol=1e-3 * np.max(np.abs(f)))

    gp_32 = _fit(GaussianProcess, 2, x, f, g, dtype="float32",
                 cond_max_target=1e6, device="cpu")
    assert gp_32.data.x.dtype == torch.float32
    mu32 = gp_32.eval_model(xq)[0]
    assert mu32.dtype == np.float32 and np.all(np.isfinite(mu32))

    gp_p = _fit(GaussianProcess, 2, x, f, g, pad_n_eval_multiple=8,
                device="cpu")
    assert gp_p.spec.n_pad_eval == 6
    np.testing.assert_allclose(gp_p.history.ln_lkd[0], gp_0.history.ln_lkd[0],
                               rtol=1e-8)
    # the padded fit stops at an optimum ~1e-8 apart in -ln L
    for a, b in zip(gp_p.eval_model(xq, calc_grad=True)[:4],
                    gp_0.eval_model(xq, calc_grad=True)[:4]):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.max(np.abs(b)))


def test_history_and_stored_hyperparameters():
    x, f, g, xq = _data(n=8)
    gp = _fit(GaussianProcess, 2, x, f, g, device="cpu")
    mu = gp.eval_model(xq)[0]
    h = gp.history
    assert np.isfinite(h.Kcov_cond[0]) and h.hp_optz_iter_max[0] >= 1
    gp.set_hpara("stored", 0)
    np.testing.assert_allclose(gp.eval_model(xq)[0], mu, rtol=1e-12)
    data = gp.export_data_surr(save2file=False)
    assert "obj_hp_theta_all" in data


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_turns_on_tf32():
    """A float32 matmul on the card runs in full float32 unless TF32 is
    turned on; no port file sets it (or lowers the float32 matmul
    precision), and importing every module and running a float32
    iterative predict (CG matvecs) leaves both switches as they were."""
    files = sorted((ROOT / "gpgradpy_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    pat = re.compile(r"allow_tf32\s*=\s*True|set_float32_matmul_precision")
    assert [str(p) for p in files if pat.search(p.read_text())] == []
    import gpgradpy_torch
    for mod in pkgutil.walk_packages(gpgradpy_torch.__path__,
                                     "gpgradpy_torch."):
        importlib.import_module(mod.name)
    x, f, g, xq = _data(n=8)
    gp = GaussianProcess(2, True, device="cpu", dtype="float32",
                         solver="iterative", cond_max_target=1e4,
                         iter_max_cg=64)
    gp.set_data(x, f, np.zeros(8), g, np.zeros((8, 2)))
    gp.set_custom_hp(theta=np.array([1.0, 0.5]))
    gp.set_hpara("current", 0)
    assert gp.eval_model(xq)[0].dtype == np.float32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "gpgradpy_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(p.relative_to(ROOT)), m) for p in files for m in _imports(p)
           if m.split(".")[0] in ("jax", "jaxlib", "gpgradpy_tpu")]
    assert bad == []
