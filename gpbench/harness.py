"""The benchmark harness of gpgradpy_torch: one cell, one process.

    python3 gpbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (an entry of ``workloads`` in BENCHMARK.json) names a configuration
and a traffic mix.  Everything the harness runs is found by name:

- ``gpbench/configs/<config>.json``: the deployment (problem, data,
  facade options, precision);
- ``gpbench/traffic/<traffic>.json``: the mix, read by the request
  generator of its ``entry`` (``gpbench/entries/<entry>.py``), which also
  drives the program's entry point and judges its answers against the
  plain reference (``gpbench/reference``);
- ``gpbench/metrics/<metric>.py``: one reader per metric, which declares
  its unit, layer, source and the end-to-end metric it moves, and reads it
  from what a run recorded, or returns None where there is nothing to read.

A run sets up (the program's kernels loaded, the data made from the seed,
every shape of the cell warmed), measures whole requests in a closed loop
until ``--seconds`` have passed, closes the window, reads the device's
memory peak, frees the program's state, judges the answers against the
reference, and prints one JSON line.  With ``--trace 1`` the harness spans
(a sync on each side) are on, the profiler traces the first requests of
the window, and the line carries the cell's per-layer metrics.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "BENCHMARK.json"
HERE = Path(__file__).resolve().parent
# packages that may not be loaded in the process that prints a result,
# compared by whole top-level module name
FORBIDDEN = ("jax", "jaxlib", "flax", "gpgradpy_tpu")
# the program's and the toolchains' build and kernel caches, at fixed
# paths inside the checkout (gpgradpy_torch builds K1/K2 into build/ itself)
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/gpbench/torch_extensions",
              "TRITON_CACHE_DIR": "build/gpbench/triton",
              "CUDA_CACHE_PATH": "build/gpbench/cuda_cache"}


THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


class BenchError(RuntimeError):
    """A run that cannot measure: it exits non-zero with no result."""


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    """A module of the harness found by name (its file may hold dots)."""
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


class Cell:
    """A cell of BENCHMARK.json resolved to its files."""

    def __init__(self, bench: dict, name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = read_json(ROOT / self.config_entry["file"])
        self.traffic = read_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])

        def mine(m):
            return "workloads" not in m or name in m["workloads"]
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def readers(self, metrics):
        """{name: (declared entry, reader module)}."""
        return {m["name"]: (m, load_module(
            HERE / "metrics" / f"{m['name']}.py",
            "gpbench_metric_" + m["name"].replace(".", "_").replace("-", "_")))
            for m in metrics}

    def entry_module(self):
        entry = self.traffic["entry"]
        return load_module(HERE / "entries" / f"{entry}.py",
                           f"gpbench_entry_{entry}")


class Record:
    """What a run recorded for the metric readers."""

    def __init__(self):
        self.setup_s = math.nan
        self.window_s = math.nan
        self.attempted = 0
        self.failed = 0
        self.latencies_s = []       # per completed request, host clock
        self.spans = {}             # name -> [seconds], harness spans
        self.counters = {}          # name -> count over the window
        self.profile = None         # profile_summary() of the traced part
        self.entry = None           # the cell's entry (shapes, problem)

    def span(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


# ---------------------------------------------------------------------------
# device trace
# ---------------------------------------------------------------------------

SPAN_PREFIX = "gpbench."


def _kernels_below(ev):
    """Device time (us) of the kernels launched by ev and its CPU
    descendants."""
    total = sum(k.duration for k in getattr(ev, "kernels", []))
    for ch in ev.cpu_children:
        total += _kernels_below(ch)
    return total


def profile_summary(prof, wall_s: float):
    """Reduce a torch.profiler run to what the readers take: device busy
    seconds (the union of the device activities' intervals), the device
    time of each kernel name, the device time launched inside each
    harness range, and the idle gaps of the device by the harness span
    open on the host where each began.  None where the profiler saw no
    device activity."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    # device activities: kernels, copies and sets, not the device-side
    # copies of the harness's profiler ranges
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and e.time_range.end > e.time_range.start
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(SPAN_PREFIX)]
    if not dev:
        return None
    ivals = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged = [list(ivals[0])]
    for a, b in ivals[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_us = sum(b - a for a, b in merged)
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                     - e.time_range.start)
    spans = [e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith(SPAN_PREFIX)]
    ranges = {}
    for e in spans:
        ranges[e.name] = ranges.get(e.name, 0.0) + _kernels_below(e)
    # idle gaps, each named by the innermost harness span open where it
    # began: the span of latest start that contains the gap's start
    spans.sort(key=lambda s: s.time_range.start)
    starts = [s.time_range.start for s in spans]
    gaps = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        label = "outside the harness spans"
        for i in range(bisect.bisect_right(starts, end) - 1, -1, -1):
            if spans[i].time_range.end > end:
                label = spans[i].name
                break
        gaps[label] = gaps.get(label, 0.0) + (nxt - end)
    return {"busy_s": busy_us / 1e6, "window_s": wall_s,
            "kernels_s": {k: v / 1e6 for k, v in by_name.items()},
            "ranges_device_s": {k: v / 1e6 for k, v in ranges.items()},
            "gaps_s": {k: v / 1e6 for k, v in gaps.items()}}


def breakdown(profile):
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(profile["kernels_s"]),
            "idle_gaps": top(profile["gaps_s"])}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def close_profile(entry, prof, t_prof, n_requests):
    entry.sync()
    wall = time.perf_counter() - t_prof
    prof.__exit__(None, None, None)
    summary = profile_summary(prof, wall)
    if summary is not None:
        summary["requests"] = n_requests
    return summary


def forbidden_loaded():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(entry, seconds: float, trace: bool, t_start: float,
             log_fn=log) -> dict:
    """Set up, measure, judge.  ``entry`` is a built entry object of
    ``gpbench/entries`` (on any device: the tests drive it on the CPU).
    Returns {"record", "checks", "memory_peak_bytes", "correct"}."""
    import torch
    rec = Record()
    rec.entry = entry
    entry.setup()
    entry.sync()
    # what set-up made stays: the collector need not walk it in the window
    gc.collect()
    gc.freeze()
    rec.setup_s = time.perf_counter() - t_start
    log_fn(f"[gpbench] set-up {rec.setup_s:.3f} s")

    n_traced = int(entry.traffic.get("trace_requests", 0)) if trace else 0
    prof = None
    if trace:
        entry.install_spans(rec)
        if n_traced and entry.on_cuda:
            # the profiler starts before the window (its start takes
            # seconds) and traces the window's first n_traced requests
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            entry.sync()
    t0 = t_prof = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        rec.attempted += 1
        r0 = time.perf_counter()
        try:
            with (torch.profiler.record_function(SPAN_PREFIX + "request")
                  if trace else contextlib.nullcontext()):
                entry.request(k)
        except Exception as exc:  # noqa: BLE001 - a failed request is counted
            rec.failed += 1
            log_fn(f"[gpbench] request {k} failed: {type(exc).__name__}: "
                   f"{exc}")
        else:
            rec.latencies_s.append(time.perf_counter() - r0)
        k += 1
        if prof is not None and k == n_traced:
            rec.profile = close_profile(entry, prof, t_prof, k)
            prof = None
    if prof is not None:       # the window closed before n_traced requests
        rec.profile = close_profile(entry, prof, t_prof, k)
    entry.sync()
    rec.window_s = time.perf_counter() - t0
    if trace:
        entry.remove_spans()
    peak = entry.memory_peak_bytes()
    log_fn(f"[gpbench] window {rec.window_s:.3f} s, {rec.attempted} requests"
           f", {rec.failed} failed")
    if rec.latencies_s:
        import numpy as np
        q = np.percentile(rec.latencies_s, [50, 90, 95, 99, 100]) * 1e3
        log_fn("[gpbench] request ms p50 p90 p95 p99 max: "
               + " ".join(f"{v:.3f}" for v in q))
    entry.release()
    checks = entry.check()
    correct = (rec.failed == 0 and rec.attempted > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    return {"record": rec, "checks": checks, "memory_peak_bytes": peak,
            "correct": correct}


def result_line(cell: Cell, out: dict, trace: bool, device: dict,
                readers: dict) -> dict:
    rec = out["record"]
    metrics = {}
    for name, (decl, mod) in readers.items():
        v = mod.read(rec)
        if v is None:
            continue
        if not math.isfinite(v):
            raise BenchError(f"metric {name} read {v}")
        metrics[name] = {"value": float(v), "unit": decl["unit"]}
    if trace and rec.profile is not None:
        device = dict(device, busy_s=rec.profile["busy_s"],
                      window_s=rec.profile["window_s"])
    line = {"correct": bool(out["correct"]), "attempted": rec.attempted,
            "failed": rec.failed, "metrics": metrics, "device": device}
    if trace and rec.profile is not None:
        line["breakdown"] = breakdown(rec.profile)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in out["checks"].items()}
    return line


def parse_args(argv):
    p = argparse.ArgumentParser(prog="gpbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the output check's control (PERF.md): the program at the precision
    # below the configuration's; never used by the benchmark's own runs
    p.add_argument("--precision", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    # one process with few threads: the program's host work (numpy,
    # scipy, torch's CPU side) runs on tiny arrays
    for var in THREAD_VARS:
        os.environ[var] = "1"
    for var, rel in CACHE_DIRS.items():
        path = ROOT / rel
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    try:
        cell = Cell(read_json(BENCH), args.workload)
        entry_mod = cell.entry_module()
        readers = cell.readers(cell.per_layer if args.trace
                               else cell.end_to_end)
        import torch
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"the cell needs {cell.chips} cards, "
                             f"{torch.cuda.device_count()} found")
        entry = entry_mod.Entry(cell.config, cell.traffic, args.seed,
                                device="cuda", precision=args.precision)
        out = run_cell(entry, args.seconds, bool(args.trace), t_start)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips,
                  "memory_peak_bytes": int(out["memory_peak_bytes"])}
        line = result_line(cell, out, bool(args.trace), device, readers)
    except BenchError as exc:
        log(f"[gpbench] {exc}")
        return 2
    found = forbidden_loaded()
    if found:
        log(f"[gpbench] modules that the benchmark must not load: {found}")
        return 3
    for name, c in line["checks"].items():
        log(f"[gpbench] check {name}: {c['value']!r} (limit {c['limit']!r})"
            f" {'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    print(json.dumps(line), flush=True)
    return 0
