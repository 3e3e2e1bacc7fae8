"""Runs of the benchmark on the card: one short run of every cell, correct,
with the contract's result line; the control, the program at float32, not
correct; and every fault of test_gpbench_faults that a cell can have,
planted at the cell's own sizes, not correct.  Each skips where there is
no CUDA device.

    python -m pytest gpbench -q -m card
"""

import json
import subprocess
import sys
import time

import pytest

from gpbench import harness
from gpbench.tests import test_gpbench_faults as faults

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(cell, *extra):
    proc = subprocess.run(
        [sys.executable, "gpbench/run.py", "--workload", cell, "--seed",
         "4000000007", "--seconds", "5", "--trace", "0", *extra],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    line = run(cell)
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_float32_is_not_correct_on_the_card(card, cell):
    line = run(cell, "--precision", "float32")
    assert not line["correct"], line["checks"]


def fault_kind(cell):
    """The kind of fault of test_gpbench_faults that a cell can have."""
    c = harness.Cell(BENCH, cell)
    if c.config["wellcond_mtd"] == "rescale_origin":
        return "rescale"
    return c.traffic["entry"]


FAULT_RUNS = [(cell, fault) for cell in CELLS
              for fault in sorted(faults.FAULTS)
              + (sorted(faults.RESCALE_FAULTS)
                 if fault_kind(cell) == "rescale" else [])]


@pytest.mark.card
@pytest.mark.parametrize("cell,fault", FAULT_RUNS)
def test_planted_fault_at_the_cells_size_is_not_correct(card, cell, fault):
    """The harness's run, without its look for a card, at the cell's own
    sizes on the card, with the fault planted under the timed path."""
    c = harness.Cell(BENCH, cell)
    entry = c.entry_module().Entry(c.config, c.traffic, 4000000009,
                                   device="cuda")
    plant = {**faults.FAULTS, **faults.RESCALE_FAULTS}[fault]
    with plant(fault_kind(cell)):
        out = harness.run_cell(entry, 4.0, False, time.perf_counter(),
                               log_fn=lambda *a: None)
    print(f"{cell} {fault}: "
          + ", ".join(f"{k} {v['value']:.3e}" for k, v in out["checks"].items()))
    assert not out["correct"], out["checks"]
