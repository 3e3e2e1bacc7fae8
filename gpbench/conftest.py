"""Test settings of the benchmark: the ``card`` marker, and small cells that
the tests drive on the CPU.

    python -m pytest gpbench -q

Tests marked ``card`` need an NVIDIA GPU; the ``card`` fixture decides
inside the test whether there is one and skips with a reason where there is
none.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


# a cell at a size a CPU test holds: d=3, three runs of 30 uniform points
SMALL = {
    "fit": ("rosen10-precon", "fit-late",
            {"runs": [0, 1, 2], "n_eval": [12, 16, 20]}),
    "rescale": ("rosen10-rescale", "fit-explore",
                {"runs": [0, 1, 2], "n_eval": [12, 16, 20]}),
    "bo_step": ("rosen10-precon", "bo-explore",
                {"runs": [0, 1, 2], "n_eval": [6, 12, 20], "n_init": 5}),
    "predict": ("rosen10-precon", "predict",
                {"runs": [0, 1, 2], "n_fit": 25, "check_requests": 20}),
}


@pytest.fixture(scope="session")
def small_data(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpbench") / "small.npz"
    rng = np.random.default_rng(0)
    np.savez(path, **{f"run{i}": rng.uniform(-2, 2, (30, 3))
                      for i in range(3)})
    return path


@pytest.fixture
def small_entry(small_data):
    """small_entry(kind, seed, precision=None) -> an Entry on the CPU."""
    from gpbench import harness

    def make(kind, seed, precision=None):
        config_name, traffic_name, over = SMALL[kind]
        config = json.loads((ROOT / "gpbench" / "configs"
                             / f"{config_name}.json").read_text())
        config["problem"]["dim"] = 3
        config["data"] = str(small_data)
        traffic = json.loads((ROOT / "gpbench" / "traffic"
                              / f"{traffic_name}.json").read_text())
        traffic.update(over)
        mod = harness.load_module(ROOT / "gpbench" / "entries"
                                  / f"{traffic['entry']}.py",
                                  f"gpbench_entry_{traffic['entry']}")
        return mod.Entry(config, traffic, seed, device="cpu",
                         precision=precision)
    return make
