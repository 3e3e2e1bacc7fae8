"""Multi-rank scaling harness (counterpart of
``examples/scaling_harness.py``): throughput against the world size at
FIXED total work, for

  * NUTS on the GP hyperparameter posterior: the chains split over the
    ranks (``parallel.mesh.run_nuts_sharded``), the pooled adaptation an
    ``all_reduce`` per warmup transition -> samples/s;
  * multistart MAP fits: the L-BFGS starts split over the ranks
    (``parallel.mesh.lbfgs_sharded``) -> starts/s.

Efficiency(N) = rate(N) / (N rate(first)).  Each world size runs as its own
process group (``parallel.mesh.run_spawned``): one spawned process per
rank, rank r on ``cuda:r`` (NCCL) or all on the CPU (gloo, a ``file://``
store, no network).  On ``cuda`` a
world size above the number of visible GPUs is refused, never moved to the
CPU.  The JSON records the backend, each world size and whether its ranks
shared a device (every CPU run does: the ranks share the host's cores, so
its numbers check the measurement path, not a speed-up);
``meets_70pct_target`` is false unless each rank had its own GPU and more
than one world size ran.

    python -m gpgradpy_torch.examples.scaling_harness --world-sizes 1 2 4 8
    python -m gpgradpy_torch.examples.scaling_harness --device cpu --world-sizes 1 2
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

DIM, N_DATA = 2, 24
LB_HP, UB_HP = -4.0, 2.0


def _problem(device):
    """The harness's GP: d=2, 24 gradient-enhanced points (the JAX
    harness's), float64."""
    import gpgradpy_torch as tgp
    from gpgradpy_torch.model import conditioning
    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (N_DATA, DIM))
    fval = np.sum((x - 0.3) ** 2, axis=1)
    fgrad = 2.0 * (x - 0.3)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    cfg = tgp.GpConfig(dim=DIM, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon")
    spec = tgp.make_data_spec(DIM, True, N_DATA, std_fval=np.zeros(N_DATA),
                              std_grad=np.zeros((N_DATA, DIM)))
    data = tgp.GpData(x=t(x), fval=t(fval), std_fval=t(np.zeros(N_DATA)),
                      grad=t(fgrad), std_grad=t(np.zeros((N_DATA, DIM))))
    return cfg, spec, tgp.HpInfo(dim=DIM), data, conditioning.calc_etaK(
        cfg, N_DATA)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_point(mesh, chains, samples, warmup, starts):
    """One world size's measurements on ``mesh`` (every rank calls it):
    NUTS samples/s and fit starts/s, each from a second, timed run after
    an untimed one, with the results both runs reach."""
    from gpgradpy_torch.fit import lhs, multistart
    from gpgradpy_torch.inference import nuts
    from gpgradpy_torch.ops import cuda_assembly
    from gpgradpy_torch.parallel.mesh import lbfgs_sharded, run_nuts_sharded
    cfg, spec, info, data, eta = _problem(mesh.device)
    cuda_assembly.reset_launches()
    lb, ub = np.full(info.n_hp, LB_HP), np.full(info.n_hp, UB_HP)
    logpost, _, _ = nuts.make_gp_logpost(cfg, spec, info, data, eta, lb, ub)
    z0 = torch.zeros((chains, info.n_hp), dtype=torch.float64,
                     device=mesh.device)
    x0 = np.asarray(lhs.lhs_sample(starts, lb + 0.5, ub - 0.5, 3))
    obj = multistart.neg_mll_objective(cfg, spec, info, data, eta)

    def timed(fn):
        fn()
        _sync(mesh.device)
        torch.distributed.barrier(
            group=mesh.group, device_ids=[mesh.device.index]
            if mesh.device.type == "cuda" else None)
        t0 = time.perf_counter()
        out = fn()
        _sync(mesh.device)
        return out, time.perf_counter() - t0

    (zs, diag), nuts_s = timed(lambda: run_nuts_sharded(
        logpost, z0, 1, mesh, n_warmup=warmup, n_samples=samples,
        max_depth=6))
    res, fit_s = timed(lambda: lbfgs_sharded(obj, x0, lb, ub, mesh,
                                             max_iter=50, tol_f=1e-12))
    return {"nuts_samples_per_s": chains * samples / nuts_s,
            "fit_starts_per_s": starts / fit_s, "nuts_s": nuts_s,
            "fit_s": fit_s, "nuts_mean_z": zs.mean((0, 1)).cpu().tolist(),
            "nuts_n_leapfrog": diag["n_leapfrog"].cpu().tolist(),
            "fit_best_f": float(np.min(res.f)),
            # this rank's K1/K2 launches over the four runs (0 on the CPU)
            "launches": {"K1": cuda_assembly.kern_grad.launches,
                         "K2": cuda_assembly.kern_grad_vjp_theta.launches}}


def compute(world_sizes=(1, 2, 4, 8), chains=64, samples=128, warmup=128,
            starts=64, device="cuda"):
    """The harness's JSON as a dict: one point per world size, each run as
    its own process group."""
    device_type = torch.device(device).type
    if device_type == "cuda":
        n_avail = torch.cuda.device_count()
        if not n_avail:
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' to run on the CPU")
        if max(world_sizes) > n_avail:
            raise ValueError(f"world sizes {list(world_sizes)}: only "
                             f"{n_avail} GPU(s) visible, one rank per GPU")
        name = torch.cuda.get_device_name(0)
    else:
        n_avail, name = os.cpu_count(), "cpu"
    for w in world_sizes:
        if chains % w or starts % w:
            raise ValueError(f"world size {w} must divide chains ({chains}) "
                             f"and starts ({starts})")
    results = {"platform": "gpu" if device_type == "cuda" else "cpu",
               "backend": "nccl" if device_type == "cuda" else "gloo",
               "device_name": name, "n_devices_avail": n_avail,
               "total_chains": chains, "nuts_samples": samples,
               "nuts_warmup": warmup, "total_starts": starts, "points": []}
    from gpgradpy_torch.parallel.mesh import run_spawned
    args = (chains, samples, warmup, starts)
    for w in world_sizes:
        pt = run_spawned(run_point, w, device_type, args)[0]
        pt.update(world_size=w, shared_device=device_type == "cpu")
        results["points"].append(pt)
    first = results["points"][0]
    base = {"nuts": first["nuts_samples_per_s"] / first["world_size"],
            "fit": first["fit_starts_per_s"] / first["world_size"]}
    for pt in results["points"]:
        w = pt["world_size"]
        pt["nuts_eff"] = pt["nuts_samples_per_s"] / (base["nuts"] * w)
        pt["fit_eff"] = pt["fit_starts_per_s"] / (base["fit"] * w)
        print(f"[scaling] world={w}: NUTS {pt['nuts_samples_per_s']:.0f} "
              f"samp/s (eff {pt['nuts_eff']:.0%}), fit "
              f"{pt['fit_starts_per_s']:.2f} starts/s (eff "
              f"{pt['fit_eff']:.0%})", file=sys.stderr)
    last = results["points"][-1]
    results["scaling_efficiency"] = min(last["nuts_eff"], last["fit_eff"])
    # one world size measures no scaling (its efficiency is 1 by definition)
    results["meets_70pct_target"] = bool(
        results["scaling_efficiency"] >= 0.70 and len(results["points"]) > 1
        and not any(pt["shared_device"] for pt in results["points"]))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world-sizes", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--chains", type=int, default=64,
                    help="fixed TOTAL NUTS chains (divisible by every size)")
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--warmup", type=int, default=128)
    ap.add_argument("--starts", type=int, default=64,
                    help="fixed TOTAL multistart fit starts")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    results = compute(args.world_sizes, args.chains, args.samples,
                      args.warmup, args.starts, args.device)
    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)


if __name__ == "__main__":
    main()
