"""Wall time, peak device memory and K1/K2 launches of dense facade fits
whose covariance carries a partial gradient set, on one CUDA card.

The problem is chip_smoke's main one (Rosenbrock, d=10, n_eval=200,
SqExp, 'precon', f64).  Two cases:

- ``padded``: ``pad_n_eval_multiple=16`` pads 200 points to 208; the 8
  padding points carry no gradient rows;
- ``idx_grad``: ``bvec_use_grad`` keeps the gradients of every other
  point.

Each fit runs the hp_best scan over 41 candidates in one batch, then the
L-BFGS.  The script imports ``gpgradpy_torch`` from ``PYTHONPATH``, so
two trees are compared on one card in one run:

    PYTHONPATH=<tree> python3 tools/partial_grad_fit.py [--repeats 3]

It prints one JSON line per case: the warm fit walls (s), the peak
memory allocated during a warm fit (GiB), the K1/K2 launches and L-BFGS
iterations of one fit, -ln L and the first predicted mean, and the ms of
one objective evaluation as the fit makes them: value and gradient at
B=1, value at B=41 (the scan).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.model import likelihood
from gpgradpy_torch.ops import cuda_assembly as ca


def _fit(x, f, g, bvec, **kw):
    n, d = x.shape
    gp = GaussianProcess(d, True, "SqExp", "precon", device="cuda", **kw)
    gp.init_optz_surr(2)
    if bvec is not None:
        g = g[bvec]
    gp.set_data(x, f, np.zeros(n), g, np.zeros(g.shape), bvec_use_grad=bvec)
    gp.set_hpara("optz", 0)
    torch.cuda.synchronize()
    return gp


def _ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def eval_ms(gp):
    """ms of one (-ln L, gradient) at B=1 and one -ln L at B=41."""
    args = (gp.cfg, gp.spec, gp.hp_info_optz_lkd, gp.data)
    eta = float(gp._etaK)
    n_hp = gp.hp_info_optz_lkd.n_hp
    z1 = torch.full((1, n_hp), -0.5, dtype=torch.float64, device="cuda")
    z41 = z1 + 0.02 * torch.arange(41, dtype=torch.float64,
                                   device="cuda")[:, None]
    with torch.no_grad():
        scan = _ms(lambda: likelihood.neg_mll(*args, z41, eta))
    grad = _ms(lambda: likelihood.neg_mll_and_grad(*args, z1, eta))
    return {"value_and_grad_B1": grad, "value_B41": scan}


def run_case(name, x, f, g, xq, bvec, repeats, **kw):
    _fit(x, f, g, bvec, **kw)                      # builds and warms up
    walls, peaks = [], []
    for _ in range(repeats):
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ca.kern_grad.launches = ca.kern_grad_vjp_theta.launches = 0
        t0 = time.perf_counter()
        gp = _fit(x, f, g, bvec, **kw)
        walls.append(time.perf_counter() - t0)
        peaks.append((torch.cuda.max_memory_allocated() - base) / 2 ** 30)
        launches = {"K1": ca.kern_grad.launches,
                    "K2": ca.kern_grad_vjp_theta.launches}
    mu = gp.eval_model(xq)[0]
    return dict(case=name, wall_s=walls, peak_gib=peaks, launches=launches,
                lbfgs_iters=gp.optz_infos[-1]["hp_optz_iter_max"],
                neg_ln_lkd=-float(gp.history.ln_lkd[0]),
                mu0=float(np.asarray(mu).ravel()[0]), eval_ms=eval_ms(gp))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    n, d = 200, 10
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    xq = rng.uniform(-2, 2, (128, d))
    bvec = np.arange(n) % 2 == 0
    print(json.dumps(run_case("padded", x, f, g, xq, None, args.repeats,
                              pad_n_eval_multiple=16)), flush=True)
    print(json.dumps(run_case("idx_grad", x, f, g, xq, bvec, args.repeats)),
          flush=True)


if __name__ == "__main__":
    main()
