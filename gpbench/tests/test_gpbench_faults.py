"""The output check fails a broken program: each cell kind driven on the
CPU through the harness's run (without its look for a card), at a size a
test holds, with a fault planted under the timed path, must come out not
correct; unbroken, and with the control (the program at float32, below
the configurations' float64), as PERF.md says.

Faults, one for each the cells can have (one card, so no exchange between
cards): a fit that returns its start unchanged, half of the data left out
(the rest fitted), and an answer altered where it is produced; and in the
rescaling configuration's own layer, the constrained fit run without its
constraint, the rescale loop's scaling vector moved, and the least point
distance that the rescaling asks for missed."""

import contextlib
import time

import numpy as np
import pytest
import torch

from gpbench import harness

KINDS = ["fit", "rescale", "bo_step", "predict"]


def run(entry, seconds=1.5):
    return harness.run_cell(entry, seconds, False, time.perf_counter(),
                            log_fn=lambda *a: None)


@contextlib.contextmanager
def patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


@contextlib.contextmanager
def state_unchanged(kind):
    """The hyperparameter fit's optimizer returns its start."""
    from gpgradpy_torch.fit import multistart, scipy_driver
    if kind == "rescale":
        def make(orig):
            def minimize(fun, x0, *a, options=None, **kw):
                return orig(fun, x0, *a, options=dict(options, maxiter=0),
                            **kw)
            return minimize
        with patched(scipy_driver, "minimize", make):
            yield
        return

    def make(orig):
        def solver(fun, x0, lb, ub, max_iter=250, **kw):
            return orig(fun, x0, lb, ub, max_iter=0, **kw)
        return solver
    with patched(multistart.lbfgs, "lbfgs_box_multistart", make):
        yield


@contextlib.contextmanager
def half_left_out(kind):
    """The fit sees the first half of the points; the predict evaluates
    the first half of a request's points and repeats them for the rest."""
    from gpgradpy_torch import GaussianProcess
    from gpgradpy_torch.model import predict
    if kind == "predict":
        def make(orig):
            def eval_model(cfg, spec, data, state, xq, **kw):
                h = max(1, xq.shape[0] // 2)
                out = orig(cfg, spec, data, state, xq[:h], **kw)
                idx = torch.arange(xq.shape[0]) % h
                return tuple(None if o is None else o[idx] for o in out)
            return eval_model
        with patched(predict, "eval_model", make):
            yield
        return

    def make(orig):
        def set_data(gp, x, f, sf=None, g=None, sg=None, **kw):
            h = max(2, len(f) // 2)
            return orig(gp, x[:h], f[:h], None if sf is None else sf[:h],
                        None if g is None else g[:h],
                        None if sg is None else sg[:h], **kw)
        return set_data
    with patched(GaussianProcess, "set_data", make):
        yield


@contextlib.contextmanager
def answer_altered(kind):
    """theta of a fit (as its optimizer returns it), a predicted mean, or a
    proposal, moved slightly where it is produced."""
    from gpgradpy_torch import GaussianProcess
    from gpgradpy_torch.bo import loop
    from gpgradpy_torch.model import predict
    if kind == "predict":
        def make(orig):
            def eval_model(*a, **kw):
                mu, *rest = orig(*a, **kw)
                return (mu * (1 + 1e-4), *rest)
            return eval_model
        with patched(predict, "eval_model", make):
            yield
        return
    if kind == "bo_step":
        # a maximum of EI moves EI in the second order only: a proposal
        # moved by 1e-2 (a 400th of the box) reads acq_rel ~1e-3
        def make(orig):
            def propose_next(*a, **kw):
                return orig(*a, **kw) + 1e-2
            return propose_next
        with patched(loop, "propose_next", make):
            yield
        return

    def make(orig):
        def run_fit(gp, *a, **kw):
            fit = orig(gp, *a, **kw)
            return fit._replace(hp_vec=fit.hp_vec + np.log10(1 + 1e-2))
        return run_fit
    with patched(GaussianProcess, "_run_fit", make):
        yield


@contextlib.contextmanager
def constraint_removed(kind):
    """The constrained fit's optimizer runs without cond(M) <= cond_max."""
    from gpgradpy_torch.fit import scipy_driver

    def make(orig):
        def minimize(fun, x0, *a, constraints=(), **kw):
            return orig(fun, x0, *a, constraints=(), **kw)
        return minimize
    with patched(scipy_driver, "minimize", make):
        yield


@contextlib.contextmanager
def scale_perturbed(kind):
    """The rescale loop's new scaling vector moved by 1% in its first
    coordinate where it is produced."""
    from gpgradpy_torch import GaussianProcess

    def make(orig):
        def rescale(gp, *a, **kw):
            theta, dist, xvec = orig(gp, *a, **kw)
            xvec = np.array(xvec, float)
            xvec[0] *= 1.01
            return theta, dist, xvec
        return rescale
    with patched(GaussianProcess, "_rescale_w_theta_sol", make):
        yield


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}
@contextlib.contextmanager
def distance_missed(kind):
    """The rescaling method's least point distance asked 1% too large."""
    from gpgradpy_torch.model import conditioning

    def make(orig):
        def vreq(n_eval, dim):
            return 1.01 * orig(n_eval, dim)
        return vreq
    with patched(conditioning, "calc_mtd_rescale_origin_vreq", make):
        yield


# faults of the layer that only the rescaling configuration has
RESCALE_FAULTS = {"constraint_removed": constraint_removed,
                  "scale_perturbed": scale_perturbed,
                  "distance_missed": distance_missed}


@pytest.mark.parametrize("kind", KINDS)
def test_sound_run_is_correct(small_entry, kind):
    out = run(small_entry(kind, 2 ** 33 + 5))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("kind", KINDS)
def test_control_at_float32_is_not_correct(small_entry, kind):
    out = run(small_entry(kind, 2 ** 33 + 5, precision="float32"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("kind", KINDS)
def test_planted_fault_is_not_correct(small_entry, kind, fault):
    entry = small_entry(kind, 2 ** 33 + 5)
    with FAULTS[fault](kind):
        out = run(entry)
    assert not out["correct"], out["checks"]
    assert np.isfinite(out["record"].window_s)


@pytest.mark.parametrize("fault", sorted(RESCALE_FAULTS))
def test_planted_rescale_fault_is_not_correct(small_entry, fault):
    entry = small_entry("rescale", 2 ** 33 + 5)
    with RESCALE_FAULTS[fault]("rescale"):
        out = run(entry)
    assert not out["correct"], out["checks"]
