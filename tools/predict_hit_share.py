"""How many of a benchmark cell's predict queries replay a CUDA graph on a
state that keeps the inverse of its factor, on the card.

Drives one cell of BENCHMARK.json through its gpbench entry (set-up, then
--requests requests of --seed) with ``predict.setup_eval`` wrapped, so that
the counter of every state the cell makes is kept, and prints their sums
over set-up and over the requests: states made and queried, captures,
replays, eager calls and inverse builds, and the hit share: replays on
states that built the inverse over all queries.  Then the device's
memory peak.

    python3 tools/predict_hit_share.py --workload rosen10-precon.predict \\
        --requests 2000 [--seed 1]
"""

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gpbench import harness  # noqa: E402
from gpgradpy_torch.model import predict  # noqa: E402

KEYS = ("captures", "replays", "eager", "inverse_builds")


def summary(counts, base):
    """Sums of the counters' growth since base (one dict per state, None
    for a state made since) and the hit share."""
    tot = dict.fromkeys(KEYS, 0)
    hits = queried = 0
    for c, b in zip(counts, base):
        delta = {k: c[k] - (b[k] if b else 0) for k in KEYS}
        for k in KEYS:
            tot[k] += delta[k]
        n = delta["captures"] + delta["replays"] + delta["eager"]
        queried += n > 0
        if c["inverse_builds"]:
            hits += delta["replays"]
    n_all = tot["captures"] + tot["replays"] + tot["eager"]
    share = hits / n_all if n_all else float("nan")
    return (f"states {len(counts)} (queried {queried}) {tot} "
            f"hit share {share:.4f} ({hits} of {n_all})")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--requests", type=int, required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()
    counts = []
    setup_eval = predict.setup_eval

    def kept(*a, **kw):
        state = setup_eval(*a, **kw)
        counts.append(state.graphs.counts)
        return state
    predict.setup_eval = kept

    cell = harness.Cell(harness.read_json(harness.BENCH), args.workload)
    entry = cell.entry_module().Entry(cell.config, cell.traffic, args.seed,
                                      device="cuda")
    entry.setup()
    entry.sync()
    print(f"[hit] {args.workload} set-up:", summary(counts, [None] * len(counts)))
    base = [dict(c) for c in counts]
    for k in range(args.requests):
        entry.request(k)
    entry.sync()
    base += [None] * (len(counts) - len(base))
    print(f"[hit] {args.workload} {args.requests} requests:",
          summary(counts, base))
    print(f"[hit] {args.workload} memory peak "
          f"{torch.cuda.max_memory_allocated()} bytes")


if __name__ == "__main__":
    main()
