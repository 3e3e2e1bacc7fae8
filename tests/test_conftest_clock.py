"""The clock of the repo's conftest.py: a test or a fixture under tests/
that runs past its time limit ends its worker with its stack, pytest-xdist
reports it failed, and the run goes on in a new worker.

One pytest run in a subprocess, one xdist worker, ``--dist loadfile``
(which puts a crashed worker's file back whole), under a copy of
conftest.py, over a module in tests/ whose own marker sets a 1 s limit: a
test that sleeps 5 s, a fixture that sleeps 5 s, a test under the limit, a
test whose marker raises its limit above its sleep, a test that comes after
the overruns, and a ``slow`` test that sleeps past the limit; and over a
module outside tests/ whose test sleeps past its marker's limit.  And a run
without xdist, which ends at its first overrun.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path
from xml.etree import ElementTree

import pytest

INNER = '''
import time

import pytest

pytestmark = pytest.mark.timeout(1)


def test_sleeps_past_its_limit():
    time.sleep(5)


@pytest.fixture
def slow_fixture():
    time.sleep(5)


def test_fixture_past_its_limit(slow_fixture):
    pass


def test_under_its_limit():
    time.sleep(0.1)


@pytest.mark.timeout(4)
def test_own_marker_raises_the_limit():
    time.sleep(1.5)


def test_runs_after_the_overruns():
    pass


@pytest.mark.slow
def test_slow_runs_unclocked():
    time.sleep(1.5)
'''

OUTSIDE = '''
import time

import pytest


@pytest.mark.timeout(1)
def test_outside_tests_runs_unclocked():
    time.sleep(1.5)
'''


@pytest.fixture(scope="module")
def inner_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("clock")
    shutil.copy(Path(__file__).parents[1] / "conftest.py", root)
    (root / "tests").mkdir()
    (root / "tests" / "test_inner.py").write_text(INNER)
    (root / "test_outside.py").write_text(OUTSIDE)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", "-n", "1", "--dist", "loadfile",
         "--junitxml=inner.xml", "-o", "markers=slow",
         # test_outside.py first: xdist hands the one worker both files at
         # the start, and never a new worker a file of one test, which it
         # would hold until a second came
         "test_outside.py", "tests/test_inner.py"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    cases = {c.get("name"): c for c in
             ElementTree.parse(root / "inner.xml").getroot().iter("testcase")}
    return proc, cases


def _outcome(case):
    for tag in ("failure", "error", "skipped"):
        if case.find(tag) is not None:
            return tag
    return "passed"


def _dump(stderr, frame):
    """The faulthandler dump whose stacks hold ``frame``: its header's
    timeout and its text."""
    dumps = re.split(r"^Timeout \((\d+:\d+:\d+)\)!$", stderr, flags=re.M)
    found = [(after, text) for after, text in zip(dumps[1::2], dumps[2::2])
             if f"in {frame}" in text]
    assert len(found) == 1, stderr
    return found[0]


# each overrun, and the frame its stack must hold
FRAMES = {"test_sleeps_past_its_limit": "test_sleeps_past_its_limit",
          "test_fixture_past_its_limit": "slow_fixture"}


def _overrun_fails_with_its_stack(inner_run, name):
    proc, cases = inner_run
    crashes = re.findall(f"worker 'gw\\d+' crashed while running "
                         f"'tests/test_inner.py::{name}'", proc.stdout)
    assert len(crashes) == 1, proc.stdout                # and it ran once
    # junit files xdist's report of a crashed test as an error
    assert _outcome(cases[name]) == "error"
    _, text = _dump(proc.stderr, FRAMES[name])
    assert "most recent call first" in text
    assert "test_inner.py" in text


def test_a_test_past_its_limit_fails_with_its_stack(inner_run):
    _overrun_fails_with_its_stack(inner_run, "test_sleeps_past_its_limit")


def test_a_fixture_past_its_limit_errors_with_its_stack(inner_run):
    _overrun_fails_with_its_stack(inner_run, "test_fixture_past_its_limit")


@pytest.mark.parametrize("name", ["test_under_its_limit",
                                  "test_own_marker_raises_the_limit",
                                  "test_runs_after_the_overruns",
                                  "test_slow_runs_unclocked",
                                  "test_outside_tests_runs_unclocked"])
def test_tests_within_their_limit_pass(inner_run, name):
    _, cases = inner_run
    assert _outcome(cases[name]) == "passed"


@pytest.mark.parametrize("name", list(FRAMES))
def test_an_overrun_costs_only_its_limit(inner_run, name):
    proc, _ = inner_run
    assert "2 failed, 5 passed" in proc.stdout
    after, _ = _dump(proc.stderr, FRAMES[name])
    assert after == "0:00:01"                  # its 5 s sleep, cut at 1 s


def test_without_xdist_an_overrun_ends_the_run(tmp_path):
    shutil.copy(Path(__file__).parents[1] / "conftest.py", tmp_path)
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_inner.py").write_text(INNER)
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "no:xdist", "-o", "markers=slow",
         "tests/test_inner.py"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    after, _ = _dump(proc.stderr, "test_sleeps_past_its_limit")
    assert after == "0:00:01"
    assert "slow_fixture" not in proc.stderr       # the run ended before it
