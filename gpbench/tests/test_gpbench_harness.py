"""The harness on the CPU: BENCHMARK.json against the contract's form,
every cell resolved to its files by name, the traffic deterministic in the
seed, the result line's keys, the import rule, and a run that finds no card
failing rather than measuring the CPU."""

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from gpbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contracts_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits its 43200 s
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gpbench/")
        assert (ROOT / c["file"]).is_file()
        names.add(c["name"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == names
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    every = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in every)
    assert len(every) == len(set(every))
    assert cells == len(set(CELLS))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files_by_name(cell):
    c = harness.Cell(BENCH, cell)
    c.entry_module()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for metrics in (c.end_to_end, c.per_layer):
        for name, (decl, mod) in c.readers(metrics).items():
            assert mod.UNIT == decl["unit"] and mod.SOURCE == decl["source"]
            if "layer" in decl:
                assert mod.LAYER == decl["layer"]
                assert mod.MOVES == decl["moves"]
                assert decl["moves"] in e2e
    for limit in c.traffic["limits"].values():
        assert limit > 0


@pytest.mark.parametrize("kind", ["fit", "bo_step", "predict"])
def test_traffic_is_deterministic_in_the_seed(small_entry, kind):
    seed = 2 ** 31 + 12345

    def draws(entry):
        if kind == "predict":
            return [entry.run] + [entry.query(k).tolist() for k in range(8)]
        return [entry.request_args(k) for k in range(12)]
    assert draws(small_entry(kind, seed)) == draws(small_entry(kind, seed))
    assert draws(small_entry(kind, seed)) != draws(small_entry(kind,
                                                               seed + 1))
    if kind != "predict":
        # every seed does the same sizes in the same order
        sizes = [a[1] for a in draws(small_entry(kind, seed))]
        assert sizes == [a[1] for a in draws(small_entry(kind, 7))]


def test_result_line_has_the_contracts_keys(small_entry):
    entry = small_entry("predict", 99)
    out = harness.run_cell(entry, 0.5, False, time.perf_counter(),
                           log_fn=lambda *a: None)
    cell = harness.Cell(BENCH, "rosen10-precon.predict")
    device = {"platform": "gpu", "kind": "test", "count": 1,
              "memory_peak_bytes": 0}
    line = harness.result_line(cell, out, False, device,
                               cell.readers(cell.end_to_end))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"setup_s", "predict_ms.p95"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    assert line["attempted"] >= 1 and line["failed"] == 0
    json.dumps(line)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_gpbench_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "gpbench").rglob("*.py"))
    assert files
    for path in files:
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)
    for path in (ROOT / "gpbench" / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "gpgradpy_torch", (path, mod)


def test_whole_name_comparison():
    # the port's name begins with the JAX package's: only whole names count
    assert "gpgradpy_torch" not in harness.FORBIDDEN
    sys.modules.setdefault("gpgradpy_tpux_probe", None)
    try:
        assert "gpgradpy_tpux_probe" not in harness.forbidden_loaded()
    finally:
        sys.modules.pop("gpgradpy_tpux_probe", None)


def _run(cwd, extra_env=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "gpbench/run.py", "--workload", CELLS[0], "--seed",
         "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_that_finds_no_card_fails_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_a_checkout_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gpbench", tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "gpgradpy_torch" in proc.stderr


def test_profile_summary_reads_busy_time_and_gaps():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, a, b, dev, children=(), kernels=()):
        return NS(name=name, time_range=NS(start=a, end=b), device_type=dev,
                  cpu_children=list(children), kernels=list(kernels),
                  is_user_annotation=False)
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    inner = ev("aten::op", 10, 20, cpu,
               kernels=[NS(name="k", device=0, duration=40.0)])
    span = ev("gpbench.cond", 5, 100, cpu, children=[inner])
    events = [span, inner, ev("k", 30, 70, gpu), ev("k2", 60, 90, gpu),
              ev("k", 150, 160, gpu), ev("k", 250, 260, gpu),
              ev("gpbench.request", 0, 300, gpu)]
    prof = NS(events=lambda: events)
    s = harness.profile_summary(prof, 1e-3)
    assert s["busy_s"] == pytest.approx(80e-6)
    assert s["kernels_s"]["k"] == pytest.approx(60e-6)
    assert s["ranges_device_s"]["gpbench.cond"] == pytest.approx(40e-6)
    assert s["gaps_s"] == {"gpbench.cond": pytest.approx(60e-6),
                           "outside the harness spans": pytest.approx(90e-6)}
    assert harness.breakdown(s)["device_ops"][0] == ["k", s["kernels_s"]["k"]]


def test_percentile_metric_is_over_every_request():
    rec = harness.Record()
    rec.latencies_s = list(np.linspace(0.001, 0.1, 100))
    mod = harness.load_module(ROOT / "gpbench" / "metrics"
                              / "predict_ms.p95.py", "p95")
    assert mod.read(rec) == pytest.approx(
        1e3 * np.percentile(rec.latencies_s, 95))


def test_predict_mix_recorder_counts_the_acquisitions_calls(small_entry):
    from gpbench.tools import record_predict_mix
    entry = small_entry("bo_step", 5)
    entry.traffic.update(runs=[0], n_eval=[12, 20])
    mix = record_predict_mix.record(entry, 5)
    assert mix["steps"] == 2 and mix["calls"] > 0
    assert sum(mix["m_counts"].values()) == mix["calls"]
    assert max(int(m) for m in mix["m_counts"]) <= 17
    q = mix["distance_quantiles"]
    assert len(q) == 21 and q == sorted(q) and q[0] >= 0.0
