"""Set-up of a pytest run in this repo: each pytest-xdist worker's share of
the host's cores, and a clock on every test under ``tests/``.

``tests/conftest.py`` (float64, the 8-device CPU mesh, the markers) loads
after this file.

Threads.  pytest-xdist runs ``-n W`` workers on one host, and each library
sizes its thread pool to the whole host unless told otherwise: torch's
intra-op pool, OpenMP, the BLAS under numpy and scipy (OpenBLAS or MKL).
Six workers on 8 cores then ran 57-81 threads each at a load average of
30-41: a NUTS test that takes 7.1 s alone took 248 s in the suite, while six
copies of it at once with one BLAS thread each took 7.8-8.4 s.  So each
worker gets ``SHARE = max(1, os.cpu_count() // W)`` threads (``W`` from
``PYTEST_XDIST_WORKER_COUNT``): the BLAS and OpenMP variables are set before
torch and scipy load their libraries (processes a test starts inherit
them), the BLAS that a plugin loaded before this file (numpy's) is limited
in place, torch runs ``SHARE`` intra-op threads and one inter-op thread,
and ``gpgradpy_torch.parallel.mesh.run_spawned`` splits the worker's threads
between the ranks it spawns.  A run without xdist keeps the libraries'
defaults, which size each pool to the host.  XLA's CPU pool keeps its
default: XLA_FLAGS has no flag for its size, and running its Eigen ops on
one thread (``--xla_cpu_multi_thread_eigen=false``) made the JAX-heavy
files slower (159-170 s against 142-143 s, six workers on 8 cores).

Clock.  The setup of a test under ``tests/`` (where module-scoped fixtures
do their work) and its call each have a time limit: ``DEFAULT_TIMEOUT``
seconds, or the seconds of a ``timeout`` marker on the test or its module
(``@pytest.mark.timeout(600)``, ``pytestmark = pytest.mark.timeout(600)``).
A phase that runs past it ends its process, and faulthandler's watchdog
thread writes every thread's stack to the process's stderr first;
pytest-xdist reports the test as failed ("worker 'gw0' crashed while
running ...") and starts a new worker for the rest of the file.
``--dist loadfile`` puts every file of the ended worker back in its queue
whole, so ``pytest_handlecrashitem`` marks the test done there (or it runs
again, and ends its worker again) and drops the files with nothing left to
run (a new worker handed only such a file would wait for work for ever).
A test that hangs then costs its limit, and the run goes on (without
xdist, the run ends there).  A signal raised in the main thread would not
do: it waits for a native call to return, a JAX test's fit is one XLA call
that can run for many minutes, and a test stopped in Python leaves its
queued XLA work running ahead of the next test's.  Tests marked ``slow``
run without a clock: they are the long runs that ``-m 'not slow'`` leaves
out.
"""

import faulthandler
import os
from pathlib import Path

import pytest

# the process's stderr before pytest captures it: the stacks of a phase past
# its limit go there, since its captured output dies with the process
STDERR = pytest.StashKey[int]()

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    SHARE = max(1, (os.cpu_count() or 1)
                // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = str(SHARE)

    import torch
    from threadpoolctl import threadpool_limits

    torch.set_num_threads(SHARE)
    torch.set_num_interop_threads(1)
    threadpool_limits(SHARE)  # numpy's BLAS: a plugin (jaxtyping) loaded it

TESTS = Path(__file__).resolve().parent / "tests"
# seconds for one phase of a test: 3x the longest phase of a run of tests/
# with six workers on 8 cores, the setup of test_torch_parallel.py's ranks
# fixture (134 s)
DEFAULT_TIMEOUT = 420.0
# files whose tests run to the clock, started first so that they end inside
# the run: test_facade_iterative.py's two fits at cond 1e6 (CG to its cap of
# 1024 inside one XLA call) take over 15 minutes each, so the file holds its
# worker for twice DEFAULT_TIMEOUT
FIRST = (TESTS / "test_facade_iterative.py",)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU")
    config.addinivalue_line(
        "markers", "timeout(seconds): time limit of each of the test's setup "
        f"and call (default {DEFAULT_TIMEOUT:g} s)")
    # xdist's schedule follows the collection's order of files, FIRST first
    # (by default it sorts files by their number of tests)
    config.option.loadscopereorder = False
    capture = config.pluginmanager.getplugin("capturemanager")
    with capture.global_and_fixture_disabled():
        config.stash[STDERR] = os.dup(2)


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: item.path.resolve() not in FIRST)


@pytest.hookimpl(optionalhook=True)  # an xdist hook
def pytest_handlecrashitem(crashitem, report, sched):
    queue = getattr(sched, "workqueue", {})  # loadscope's and loadfile's
    for scope, work_unit in list(queue.items()):
        if crashitem in work_unit:
            work_unit[crashitem] = True
        if all(work_unit.values()):
            del queue[scope]


def _limit(item):
    """The item's time limit in seconds, or None where it has no clock."""
    if (not item.path.resolve().is_relative_to(TESTS)
            or item.get_closest_marker("slow")):
        return None
    marker = item.get_closest_marker("timeout")
    return float(marker.args[0]) if marker else DEFAULT_TIMEOUT


def _clocked(item):
    limit = _limit(item)
    if limit is not None:
        faulthandler.dump_traceback_later(
            limit, file=item.config.stash[STDERR], exit=True)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _clocked(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _clocked(item))
