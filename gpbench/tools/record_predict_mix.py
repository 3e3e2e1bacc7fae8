#!/usr/bin/env python3
"""Records the surrogate queries that BO explore steps make: the mix that
the predict traffic (gpbench/traffic/predict.json) draws from.

    python3 gpbench/tools/record_predict_mix.py --seed <n> [--out <file>]

Runs one explore step of the cell rosen10-precon.bo-explore at every
(run, n_eval) pair of its cycle, on the card, and records every batched
``predict.eval_model`` call that ``propose_next``'s acquisition L-BFGS
makes: its number of rows, and each row's distance to the nearest data
point.  Prints, and writes to --out, the count of calls of each number of
rows and the quantiles of the distance, every 5%.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from gpbench import harness  # noqa: E402

CELL = "rosen10-precon.bo-explore"


def record(entry, seed):
    """Runs one explore step of ``entry`` (a bo_step entry) at every
    (run, n_eval) pair of its traffic's cycle and returns the mix of the
    acquisition's queries."""
    import torch
    from gpgradpy_torch.model import predict
    from gpbench.entries import common
    entry.install_capture()
    rows, dists, by_n = [], [], {}
    orig = predict.eval_model

    def eval_model(cfg, spec, data, state, xq, **kw):
        if entry._capture.get("in_propose"):
            x = data.x[:spec.n_eval].to(xq.dtype)
            r = xq[:, None, :] - x[None, :, :]
            near = torch.sqrt((r * r).sum(-1)).min(1).values
            rows.append(int(xq.shape[0]))
            dists.extend(near.cpu().tolist())
            by_n.setdefault(spec.n_eval, []).append(int(xq.shape[0]))
        return orig(cfg, spec, data, state, xq, **kw)

    predict.eval_model = eval_model
    t0 = time.perf_counter()
    t = entry.traffic
    k = 0
    try:
        for run in t["runs"]:
            for n in t["n_eval"]:
                step_seed = int(common.seed_rng(seed, 1, k).integers(1, 2 ** 31))
                entry.step(run, n, step_seed)
                k += 1
    finally:
        predict.eval_model = orig
        entry.unpatch()
    counts = np.bincount(rows)
    return {"steps": k, "calls": len(rows),
            "seconds": time.perf_counter() - t0,
            "m_counts": {str(m): int(c) for m, c in enumerate(counts) if c},
            "m_mean": float(np.mean(rows)),
            "m_mean_by_n_eval": {str(n): float(np.mean(v))
                                 for n, v in sorted(by_n.items())},
            "calls_by_n_eval": {str(n): len(v)
                                for n, v in sorted(by_n.items())},
            "distance_quantiles": [float(q) for q in np.quantile(
                dists, np.linspace(0.0, 1.0, 21))]}


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the mix is recorded on the card")
    cell = harness.Cell(harness.read_json(harness.BENCH), CELL)
    entry = cell.entry_module().Entry(cell.config, cell.traffic, args.seed,
                                      device="cuda")
    text = json.dumps(record(entry, args.seed), indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
