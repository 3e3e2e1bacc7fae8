"""What the predict's CUDA graphs cost and save on the card.

Fits the d=10 Rosenbrock (a=10) at n_eval points of a Latin hypercube
(`precon`, the facade's defaults) and prints, for each query row count m:
the median host time of one ``eval_model(x, calc_grad=True)`` through the
facade (a graph replay), of the eager body with the four outputs copied to
the host one by one (the facade's path without the graphs), and of the
first call of a new key on a fresh state (warm-up, capture, first replay;
at m = 1 also the build of the inverse of the factor that the state keeps).
Then the graph counter, the time of a new state solve's first call (the
build of that inverse, ``predict.choose_solve``, and one solve), and the
device time the profiler sees in a window of replays, with the kernels
that take most of it (kernels inside a graph replay are traced as
kernels).

    python3 tools/predict_graph_cost.py [--n-eval 161] [--reps 41]
"""

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpgradpy_torch import GaussianProcess  # noqa: E402
from gpgradpy_torch.fit import lhs  # noqa: E402
from gpgradpy_torch.model import predict  # noqa: E402


def rosen(x, a=10.0):
    f = np.sum(a * (x[:, 1:] - x[:, :-1] ** 2) ** 2
               + (1.0 - x[:, :-1]) ** 2, axis=1)
    g = np.zeros_like(x)
    g[:, :-1] = (-4.0 * a * x[:, :-1] * (x[:, 1:] - x[:, :-1] ** 2)
                 - 2.0 * (1.0 - x[:, :-1]))
    g[:, 1:] += 2.0 * a * (x[:, 1:] - x[:, :-1] ** 2)
    return f, g


def timed(fn, *a):
    t0 = time.perf_counter()
    fn(*a)
    return time.perf_counter() - t0


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n-eval", type=int, default=161)
    p.add_argument("--reps", type=int, default=41)
    args = p.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()} torch {torch.__version__}")
    d, n = 10, args.n_eval
    lb, ub = -2.0 * np.ones(d), 2.0 * np.ones(d)
    x = lhs.lhs_sample(n, lb, ub, seed=0)
    f, g = rosen(x)
    gp = GaussianProcess(d, True, "SqExp", "precon")
    gp.init_optz_surr(1)
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
    gp.set_hpara("optz", 0)
    rng = np.random.default_rng(1)
    cfg, spec, data = gp.cfg_predict, gp.spec, gp.data

    def eager(xq_host):
        xq = gp._query(xq_host, False)
        with torch.no_grad():
            out = predict._eval_model(cfg, spec, data, gp._eval_state, xq,
                                      True, False)
        return [None if v is None else v.cpu().numpy() for v in out]

    gp.set_hpara("current", 0)                # a fresh state
    print("m graph_ms eager_ms first_call_ms")
    for m in range(1, 18):
        qs = [rng.uniform(-2.0, 2.0, (m, d)) for _ in range(args.reps)]
        first = timed(gp.eval_model, qs[0], True)
        for q in qs[:3]:
            eager(q)
        t_g = [timed(gp.eval_model, q, True) for q in qs]
        t_e = [timed(eager, q) for q in qs]
        print(f"{m} {1e3 * statistics.median(t_g):.4f} "
              f"{1e3 * statistics.median(t_e):.4f} {1e3 * first:.3f}")
    print("[counts]", predict.graph_counts(gp._eval_state))
    ops, t_inv = gp._eval_state.ops, []
    b = torch.zeros_like(gp._eval_state.invK_fdiff)[:, None]
    for _ in range(5):
        counts = {"inverse_builds": 0}
        solve = predict.choose_solve(cfg, ops, counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(b)
        torch.cuda.synchronize()
        t_inv.append(time.perf_counter() - t0)
        assert counts["inverse_builds"] == 1
    print(f"[inverse] N {ops.fac.L.shape[-1]} build + one solve ms: first "
          f"{1e3 * t_inv[0]:.3f}, median {1e3 * statistics.median(t_inv):.3f}")

    from torch.profiler import ProfilerActivity, profile
    qs = [rng.uniform(-2.0, 2.0, (4, d)) for _ in range(50)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            gp.eval_model(q, True)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type != torch.autograd.DeviceType.CPU]
    busy = sum(e.time_range.end - e.time_range.start for e in dev) / 1e3
    print(f"[profile] 50 replays at m=4: {len(dev)} device events, "
          f"{busy:.3f} ms device (summed), {1e3 * wall:.3f} ms wall")
    by_name = {}
    for e in dev:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) / 1e3)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {ms:8.3f} ms  {name[:90]}")


if __name__ == "__main__":
    main()
