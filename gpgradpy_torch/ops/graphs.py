"""CUDA-graph capture for the predict (``model/predict``) and the CG update
(``iterative.mbcg``).  A capture cannot run on the default stream: all run
on one side stream per device, made once, so its library workspaces are
made once.  A captured body runs once on that stream first, as cuBLAS and
cuSOLVER make their handles and workspaces on a stream's first call, which
a capture cannot hold.  The capture is the bare ``capture_begin`` /
``capture_end``: ``torch.cuda.graph``'s context also collects garbage and
empties the allocator's cache, ~0.1 s a capture.
"""

from __future__ import annotations

import contextlib

import torch

_SIDE_STREAMS = {}


@contextlib.contextmanager
def on_side(device: torch.device):
    """Run the body on the device's side stream, after the work queued on
    the current stream and before the work queued on it later."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    side, main = _SIDE_STREAMS[device], torch.cuda.current_stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def capture(fn, pool=None):
    """(graph, fn()): fn's kernels captured into a new graph, inside
    ``on_side``; in ``pool`` (another graph's ``graph.pool()``, for graphs
    that replay in turn) where one is given, else in a pool of its own."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin(pool=pool)
    try:
        out = fn()
    finally:
        graph.capture_end()
    return graph, out
