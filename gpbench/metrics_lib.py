"""What the metric readers of gpbench/metrics share.  Each reader takes
the run's Record (gpbench/harness.py) and returns a number, or None where
the run recorded nothing to read it from."""

from __future__ import annotations

import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SLEEP_CYCLES = 400_000_000     # ~0.2 s at the H100's clock

# kernel-name keywords of the factorization's layer: the Cholesky, and the
# triangular solves and products around it (solves, its autograd backward)
FACTORIZATION = ("potrf", "getrf", "trsm", "trsv", "gemm", "gemv", "syrk",
                 "herk", "trmm", "dot", "potrs", "potri")


def per_request(rec, total):
    n = rec.profile.get("requests", 0) if rec.profile else 0
    return None if not n else total / n


def window_mean(rec):
    """Seconds per completed request over the whole window."""
    if not rec.latencies_s:
        return None
    return rec.window_s / len(rec.latencies_s)


def idle_share(rec):
    if rec.profile is None or rec.profile["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.profile["busy_s"] / rec.profile["window_s"])


def device_s_of(rec, keywords):
    if rec.profile is None:
        return None
    return sum(s for name, s in rec.profile["kernels_s"].items()
               if any(k in name.lower() for k in keywords))


def assembly_roofline(rec, which: str):
    """Share of the bytes bound of the program's covariance assembly entry
    (KernGradFn: forward for K1, its theta-VJP for K2) at the cell's shapes,
    in %.  Bound: each output (K1) or cotangent (K2) element moved once
    over the data sheet's bandwidth.  Time: CUDA events on the device's
    stream around each call, the L2 flushed before it.  Every call of a
    shape is enqueued behind one long sleep of the device, and the sleep
    must still run once the host has enqueued them all, so that no host
    work falls between two events (a run where it does not is retried
    with a sleep twice as long).  The shapes (a B=41 start scan and B=1
    evaluations at the traffic's roofline n_eval) are weighted as a fit
    runs them: one scan and the rest of its likelihood calls at B=1."""
    entry = rec.entry
    if not entry.on_cuda or "lkd_calls" not in rec.counters:
        return None
    import torch
    from gpgradpy_torch.model.assembly import KernGradFn
    spec = entry.traffic["roofline"]
    n = int(spec["n_eval"])
    x = entry.problem.data(0, n)[0]
    dt = torch.float64 if entry.precision == "float64" else torch.float32
    dev = entry.device
    xt = torch.as_tensor(x, dtype=dt, device=dev)
    d = x.shape[1]
    N = (1 + d) * n
    esize = torch.finfo(dt).bits // 8
    rng = np.random.default_rng(0)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float64, device=dev)
    calls = rec.counters["lkd_calls"] / max(1, len(rec.latencies_s))
    bound = spent = 0.0
    for B, weight, reps in ((int(spec["scan_rows"]), 1.0, 5),
                            (1, max(calls - 1.0, 1.0), 20)):
        th = torch.as_tensor(10.0 ** rng.uniform(-3, 1, (B, d)), dtype=dt,
                             device=dev)
        if which == "K1":
            def fn():
                return KernGradFn.apply(entry.config["kernel_type"], xt, th,
                                        None)
        else:
            th.requires_grad_(True)
            K = KernGradFn.apply(entry.config["kernel_type"], xt, th, None)
            G = torch.randn_like(K)

            def fn():
                return torch.autograd.grad(K, th, G, retain_graph=True)
        fn()
        torch.cuda.synchronize(dev)
        ms = _timed_behind_sleep(fn, flush, reps)
        b_s = B * N * N * esize / HBM_BYTES_PER_S
        print(f"[gpbench] {which} at B={B}, N={N}: {ms:.4f} ms, bound "
              f"{1e3 * b_s:.4f} ms, weight {weight:.1f}", file=sys.stderr)
        bound += weight * b_s
        spent += weight * ms / 1e3
        del fn
        if which == "K2":
            del K, G
    return 100.0 * bound / spent


def _timed_behind_sleep(fn, flush, reps, sleep_cycles=SLEEP_CYCLES):
    """Mean device ms of fn over reps calls, each between two CUDA events
    and after an L2 flush, all enqueued behind one sleep of the device
    that outlasts the host's enqueueing."""
    import torch
    for _ in range(8):
        torch.cuda._sleep(sleep_cycles)
        slept = torch.cuda.Event()
        slept.record()
        events = []
        for _ in range(reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        host_first = not slept.query()
        torch.cuda.synchronize()
        if host_first:
            return sum(a.elapsed_time(b) for a, b in events) / reps
        sleep_cycles *= 2
    raise RuntimeError("the host's enqueueing outlasted every sleep")
