"""Large-n GP demo: fit and predict without materializing the covariance,
the training points split over the ranks of a process group (counterpart
of ``examples/large_n_demo.py``).

  1. theta by gradient descent in log10 space on the determinant-free
     iterative MLL gradient (CG solves and the Hutchinson trace through the
     sharded matvec);
  2. posterior mean and std at held-out points through ``predict_iterative``
     (the cross covariance split over the ranks, the query solves batched
     into one CG call).

    python -m gpgradpy_torch.examples.large_n_demo --n 512 [--device cpu]
    torchrun --nproc-per-node 2 -m gpgradpy_torch.examples.large_n_demo --n 512 --device cpu

Without a launcher it runs on a group of one rank (the card, or the CPU
with ``--device cpu``); under ``torchrun`` every rank runs it and rank 0
prints.  ``compute`` imports no matplotlib (there is no plot).
"""

import argparse
import json
import time

import numpy as np
import torch

from gpgradpy_torch import GpConfig, GpData, make_data_spec
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.model import conditioning, likelihood_iter, predict_iter
from gpgradpy_torch.ops import iterative
from gpgradpy_torch.parallel import sharded_matvec as sm
from gpgradpy_torch.types import Hypers

N_PROBES = 8


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def compute(n=512, dim=4, steps=30, device="cuda", probes=None,
            verbose=True):
    """The demo's fit and predict; returns its numbers as a dict.
    ``probes(step, n_full)`` gives each step's (n_full, 8) probes in the
    point-major layout (default: the port's Rademacher probes seeded with
    the step)."""
    mesh = sm.make_data_mesh(device=device)
    dev = mesh.device
    n -= n % mesh.size
    say = print if verbose and mesh.rank == 0 else (lambda *a, **k: None)
    say(f"ranks: {mesh.size} ({mesh.backend}), n_eval={n}, "
        f"n_data={n * (1 + dim)}")

    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (n, dim))
    f, g = rosenbrock(x)
    xq = rng.uniform(-2, 2, (64, dim))
    fq, _ = rosenbrock(xq)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=torch.float64, device=dev)

    cfg = GpConfig(dim=dim, use_grad=True, kernel_type="SqExp",
                   wellcond_mtd="precon", cond_max_target=1e6)
    spec = make_data_spec(dim, True, n, std_fval=np.zeros(n),
                          std_grad=np.zeros((n, dim)))
    data = GpData(x=t(x), fval=t(f), std_fval=t(np.zeros(n)), grad=t(g),
                  std_grad=t(np.zeros((n, dim))))
    eta = conditioning.calc_etaK(cfg, n)
    n_full = n * (1 + dim)

    # --- 1. theta: gradient descent in log10 space, each step's gradient
    # clipped to a trust region (the stochastic trace makes raw gradients
    # heavy-tailed) and theta kept in the usual optimization box
    log_theta = np.zeros(dim) - 1.0
    lr = 0.15
    trace = []
    _sync(dev)
    t0 = time.perf_counter()
    for it in range(steps):
        z = (probes(it, n_full) if probes is not None else sm.blocked_to_pm_mat(
            iterative.rademacher(n_full, N_PROBES, it), n, dim).numpy())
        val, gth, info = likelihood_iter.neg_mll_iterative_and_grad(
            cfg, spec, data, Hypers(theta=t(10.0 ** log_theta)), eta, t(z),
            max_cg_iters=400, cg_tol=1e-8, mesh=mesh)
        glog = gth.cpu().numpy() * 10.0 ** log_theta * np.log(10.0)
        log_theta = np.clip(log_theta - lr * np.clip(glog, -1.0, 1.0),
                            -4.0, 2.0)
        trace.append(float(val))
        if it % 10 == 0 or it == steps - 1:
            say(f"  step {it:3d}: -lnL = {float(val):10.2f}  theta = "
                f"{np.round(10.0 ** log_theta, 4)}  cg_resid = "
                f"{float(info.cg_resid):.1e}")
    _sync(dev)
    fit_s = time.perf_counter() - t0
    say(f"fit: {fit_s:.1f}s")

    # --- 2. the posterior at the held-out points
    t0 = time.perf_counter()
    mu, sig, _, _, res = predict_iter.predict_iterative(
        cfg, spec, data, Hypers(theta=t(10.0 ** log_theta)), eta, t(xq),
        max_cg_iters=300, mesh=mesh)
    _sync(dev)
    predict_s = time.perf_counter() - t0
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    rmse = float(np.sqrt(np.mean((mu - fq) ** 2)))
    say(f"predict: {predict_s:.1f}s  held-out rmse = {rmse:.4g} "
        f"({rmse / np.std(fq):.2%} of f-scale), mean sig = "
        f"{float(np.mean(sig)):.4g}")
    return {"world_size": mesh.size, "backend": mesh.backend,
            "device": str(dev), "n_eval": n, "n_data": n_full,
            "neg_lnL": trace, "theta": (10.0 ** log_theta).tolist(),
            "mu": mu.tolist(), "sig": sig.tolist(), "rmse": rmse,
            "rmse_over_std": rmse / float(np.std(fq)),
            "mean_sig": float(np.mean(sig)),
            "predict_cg_resid": float(res.residnorm.max()),
            "fit_s": fit_s, "predict_s": predict_s}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512,
                    help="n_eval (n_data = n*(1+dim)); cut to a multiple of "
                         "the world size")
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = compute(args.n, args.dim, args.steps, args.device)
    if out["world_size"] == 1 or torch.distributed.get_rank() == 0:
        print(json.dumps({k: v for k, v in out.items()
                          if k not in ("mu", "sig")}))


if __name__ == "__main__":
    main()
