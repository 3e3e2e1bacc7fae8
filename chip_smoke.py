#!/usr/bin/env python3
"""Smoke test of gpgradpy_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. card: name and power limit (nvidia-smi), TF32 off;
  2. build: the CUDA kernels K1/K2 from gpgradpy_torch/csrc with nvcc, and
     each kernel's registers, shared memory and spills (-Xptxas -v);
  3. kernel checks: K1 and K2 against their plain PyTorch versions on the
     card, 3 families x f32/f64 x square/rectangular/ragged x batched, and
     the edges of the kernels' tiling and 16-byte accesses: d=1, d=33,
     n1=201 against n2=37 (rows that break 16-byte alignment), B=2, each
     also in f32 and all three families, the iterative path's row
     tiles (256 and the ragged 208 points against 2000, f64) and the BO
     loop's (n=106 at B=41 and B=1, n=8 at B=41), the polish's bench
     problem (n=64, d=4 at B=41 and B=1), lkd_grid's batch (n=200, d=10,
     B=100), the d=5 trace worker's (n=15 at B=41 and B=1, n=6 at
     B=41) and [dist]'s (n=376 at B=1, 2000 points against 128, 256
     against 2048 at d=4, n=24 at d=2 and B=8); then K2 run twice on
     the same inputs at the main path's shape (B=1, B=41) must agree
     bitwise;
  4. main path, through the GaussianProcess facade in f64: a d=10,
     n_eval=200 Rosenbrock fit (twice; the second is timed warm) and
     prediction with gradients at 128 held-out points, the same fit with
     RatQu (alpha fitted), then the bench.py problem (d=4, n_eval=64)
     against its RMSE gate, and small fits (3 families, float32, the
     constrained and rescaling methods, trust-constr) compared with the
     port's CPU path.  Each path runs with the launch counts set to 0 just
     before it, prints its own K1/K2 counts and fails unless both launched
     (the gradient-free small fit launches no K1 and runs outside that
     check);
  5. constrained fits at the same width: 'base' (spectral cond, SLSQP under
     cond <= cond_max) and 'rescale_origin' ('fro' cond, the rescale
     fixed-point loop), each followed by prediction with gradients at 128
     held-out points; each fails unless its condition number at the
     optimum is within 1.01 cond_max and its outputs are finite;
  6. the iterative solver (solver='iterative'): its matvec KernMatvecFn
     (K1 per row tile + product; K2 per tile in the theta backward) against
     the plain kern_matvec, forward and theta gradient, 3 families x
     f64/f32, n_eval=201 in tiles of 64, full and masked (partial-gradient,
     noise and eta) layouts, one launch per tile; the graphed CG update
     against the eager one; '[iterative]': a d=10, n_eval=200 facade fit
     held to the dense fit by the JAX criterion, its predict against the
     dense predict at the same theta, and one objective under the
     profiler; '[iterative-large]': predict at n_eval=2000 (N = 22 000)
     against the dense facade, one timed objective, each CG solve and both
     peak memories; iterative fits on the card against the CPU ('precon'
     and the rescale loop), with eval_model_var and make_predict_fn on the
     card held to eval_model;
  7. hyperparameter inference over make_gp_logpost: '[nuts-d10]'
     sample_posterior with 8 chains on the d=10, n_eval=200 fit (depth
     cut to NUTS_D10): one batched leapfrog timed, the log posterior's
     value and gradient on the card held to the CPU path, then samples
     (finite, divergence share < 0.05, median log10 theta within 0.6 of
     the MAP), R-hat, ESS, samples/s, peak memory and the idle share of
     two transitions; '[nuts-256]' bench.py's 256-chain NUTS
     configuration, transitions cut (samples/s, idle share); '[advi]' and
     '[smc]' with the JAX defaults on the same target.  Each runs as a
     path with its own launch counts (SMC: value only, K1);
  8. the BO loop: '[bo-d10]' resumes the paper's d=10 run (Rosenbrock,
     SqExp, precon, EI, the local trust-region exploit) from the repo's
     trace after 104 evaluations and runs 6 steps, 3 explore (a global
     refit and propose_next) and 3 exploit (a local GP): per step its
     seconds, the acquisition L-BFGS's iterations and calls and its own
     K1/K2 counts (explore: both must launch; exploit: K1), finite
     results in the box, the card's EI and gradient held to a CPU GP with
     the card's hyperparameters, EI at both proposals, and one
     propose_next profiled;
  9. precision, utils and examples: '[polish]' fits the bench problem
     (d=4, n_eval=64) and d=10, n_eval=200 three ways (f64 at cond 1e10,
     f32 at 1e6, f32 at 1e6 + the f64 polish at 1e10), each with its warm
     fit wall (median of 3), -ln L of its optimum under one f64 function,
     held-out RMSE and K1/K2 launches (the polish's f64 ones apart), and
     fails unless the polished -ln L meets the f64 fit's (rtol 1e-6), the
     d=4 gate holds (f64 and polished) and K1/K2 launch in both the f32 fit
     and the f64 polish; a refined predict (f32 factor, 2 refinements)
     held to the f64 predict at the same hyperparameters (1e-6); the f32
     and f64 Cholesky at N=2200.  '[utils]': lkd_grid at d=10, n_eval=200,
     n_grid 10 (one K1 launch at B=100), three grid points held to single
     card evaluations (1e-10; 5e-9 at cond >= 1e8) and one to the CPU
     port (1e-9), and
     get_txt_info_surr printed.  '[examples]': the compute parts of
     plt_cond, plt_nugget_1d, plt_kern_corr and plt_surr_1d on the card
     held to the CPU, and one run_paper_traces worker (Precondition, start
     0, d=5, 8 iterations) with its seconds per iteration, loaded back
     through PltOptzResults;
  9b. the multi-device layer, '[dist]', on a world-size-1 NCCL group (a
     file:// store under build/; the backend is printed and must be nccl):
     the sharded matvec at [iterative-large]'s size (N = 22 000, 34
     columns) against KernMatvecFn (forward and theta gradient, 1e-13),
     with ms per matvec and its collectives; one iterative objective and
     predict_iterative with the mesh against the mesh-free ones on the same
     probes (1e-10; predict mu 1e-8, sig 1e-7; cond_max_target 1e4, CG
     converged); cholesky_dist at
     N = 4096 (block 64) against torch.linalg.cholesky (1e-9 of max|L|,
     logdet 1e-10) with both times; the facade's solver='dense_dist' fit at
     d=10, n_eval=372 (padded to 4096 rows) against the dense fit (-ln L
     and mu at 128 points, 1e-6); sample_posterior(use_mesh=True) against
     run_nuts with pooled adaptation (1e-12); the compute parts of
     large_n_demo (n=2048, d=4, 3 steps) and scaling_harness (world size
     1, its rank's K1/K2 counts) with their JSON;
 10. times at the main path's shape with CUDA events: each kernel at B=1
     and B=41 beside its bound, its plain version and the first port's
     time, and at the iterative path's row tile (256 x 2000 points); for
     context, one PyTorch write (fill_) and read (sum) of as many bytes,
     the row tile's products, KernGradFn's RatQu backward with and without
     alpha, and one Cholesky; the warm d=10 fit repeated; one warm d=10 fit
     of 'precon' and one of 'base' under torch.profiler, device time by
     layer.
Each phase prints its seconds.  A "[summary]" JSON line gathers the
results.  Phase names given as arguments (e.g. "bo-d10", "dist", or
"polish utils examples") run those phases alone after card and build,
without the two closing lines.  The line before the last is a JSON object {"kernels": [...]}
whose launch counts are those of the warm d=10 fit + predict; the last
line is {"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"float64": 34e12,    # H100 SXM data sheet, FP64 outside the
              "float32": 67e12}    # tensor cores; FP32 likewise
SOURCE = "gpgradpy_torch/csrc/kern_assembly.cu"
REPLACES = {"K1": "gpgradpy_tpu/ops/pallas_assembly.py:224",
            "K2": "gpgradpy_tpu/ops/pallas_assembly.py:416"}
TOL = {  # max |kernel - plain| / max |plain|
    # K1: one transcendental and a d-term sum per element, so a few ulp of
    # the largest entry
    ("K1", "float64"): 1e-12, ("K1", "float32"): 2e-6,
    # K2: a sum of (1+d)^2 n1 n2 signed terms (4.8M at the main path's
    # shape) taken in another order than autograd's; the f32 bound allows
    # eps * sqrt(terms) growth against the cancelling sum
    ("K2", "float64"): 1e-10, ("K2", "float32"): 1e-3,
}
# the first port's kernels (one block per 32x32 point tile and batch row):
# f64 SqExp n=200 d=10, ms at B=1 and B=41 (PERF.md section 6, first
# port's own record; NVIDIA H100 80GB HBM3, 700 W)
FIRST_PORT_MS = {("K1", 1): 0.0529, ("K1", 41): 0.6154,
                 ("K2", 1): 0.2399, ("K2", 41): 0.8395}


def log(*a):
    print(*a, flush=True)


def phase_card(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[card] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" | torch {torch.__version__} cuda {torch.version.cuda} | tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build(ca):
    t0 = time.perf_counter()
    path = ca.build()
    ca._load()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {ca.build_seconds:.2f} s)")
    for line in ca.build_log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(kern_[a-z_]+)I([df])"
                      r"(?:Li(\d)E)?", line)
        if m:
            log(f"[build]   {m[1]}<{'double' if m[2] == 'd' else 'float'}"
                f"{'' if m[3] is None else ', family ' + m[3]}>")
        elif "registers" in line or "spill" in line or "error" in line:
            log("[build]     " + line.strip())


# K2's cotangent of more entries than this is drawn on the card: a host
# draw takes ~2.5 s per 10^8 entries, several minutes over every check
GBAR_HOST_MAX = 10 ** 8


def _inputs(torch, rng, n1, n2, d, B, dtype, kernel_type, same):
    dev = "cuda"
    x1 = rng.uniform(-2, 2, (n1, d))
    x2 = x1 if same else rng.uniform(-2, 2, (n2, d))
    shape = (d,) if B is None else (B, d)
    theta = 10.0 ** rng.uniform(-2, 0, shape)
    alpha = None
    if kernel_type == "RatQu":
        alpha = 2.0 if B is None else rng.uniform(0.5, 5.0, B)
    rows = 1 if B is None else B
    shape = (rows, (d + 1) * n1, (d + 1) * n2)

    def t(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype, device=dev)
    if np.prod(shape) > GBAR_HOST_MAX:
        # drawn on the card from a seed of the host's stream
        gen = torch.Generator(device=dev).manual_seed(
            int(rng.integers(2 ** 62)))
        gbar = torch.randn(shape, generator=gen, dtype=dtype, device=dev)
    else:
        gbar = t(rng.standard_normal(shape))
    if B is None:
        gbar = gbar[0]
    return t(x1), t(x2), t(theta), t(alpha), gbar


def phase_kernels(torch, ca):
    """K1/K2 against their plain versions, at the main path's shapes, the
    tiling's edges and the shapes of the iterative, BO, polish, utils,
    examples and dist phases (listed in ``cases``; the shapes of 2000
    points or more in f64 only); returns the max abs errors at the main
    path's shapes (f64, n=200, d=10)."""
    rng = np.random.default_rng(0)
    cases = [  # (n1, n2, d, B, same points)
        (37, 37, 3, None, True),     # ragged, square
        (37, 20, 3, 3, False),       # ragged, rectangular, batched
        (200, 200, 10, None, True),  # main path: L-BFGS / setup_eval
        (200, 128, 10, None, False), # main path width, rectangular
        (200, 200, 10, 41, True),    # main path: hp_best scan batch
        # edges of the tiling over derivative rows and of the 16-byte
        # loads and stores
        (64, 64, 1, None, True),     # d=1: two derivative rows
        (40, 33, 33, None, False),   # d=33: 34 column blocks per row
        (201, 37, 5, 2, False),      # ragged, rectangular, rows not 16-byte
                                     # aligned (element-wise access), B=2
        # the inference phases: a NUTS leapfrog of 8 chains at the main
        # path's width ([nuts-d10]) and of 256 chains on bench.py's NUTS
        # problem ([nuts-256])
        (200, 200, 10, 8, True),
        (32, 32, 2, 256, True),
        # the [iterative-large] matvec's row tiles (f64 only): 256 points
        # against n_eval=2000, and the ragged last tile of 208
        (256, 2000, 10, None, False),
        (208, 2000, 10, None, False),
        # [bo-d10]: the global refit at n_eval 104-106 (its scan batch and
        # its L-BFGS rows) and the exploit phase's local GP of 8 points
        (106, 106, 10, 41, True),
        (106, 106, 10, None, True),
        (8, 8, 10, 41, True),
        # [polish]: the bench problem's scan batch and L-BFGS rows (the f32
        # main fit and the f64 polish); [utils]: lkd_grid's 10 x 10 grid in
        # one batch
        (64, 64, 4, 41, True),
        (64, 64, 4, None, True),
        (200, 200, 10, 100, True),
        # [examples]: the d=5 run_paper_traces worker's global refit at
        # n_eval up to 15 and its local GP of 6 points
        (15, 15, 5, 41, True),
        (15, 15, 5, None, True),
        (6, 6, 5, 41, True),
        # [dist]: the dense_dist fit's covariance (372 points + 4 padding,
        # one row), the dense reference fit on the same 372 points (its
        # scan batch and its L-BFGS rows), the sharded predict's cross
        # covariance (2000 points against 128 queries), large_n_demo's row
        # tiles (256 of 2048 points, d=4) and its sharded predict's cross
        # covariance (2048 points against 64 queries), scaling_harness's
        # 8-chain leapfrog (n=24, d=2)
        (376, 376, 10, None, True),
        (372, 372, 10, 41, True),
        (372, 372, 10, None, True),
        (2000, 128, 10, None, False),
        (256, 2048, 4, None, False),
        (2048, 64, 4, None, False),
        (24, 24, 2, 8, True),
        # a padded fit's scan batch (n_eval=200 padded to 208 by
        # pad_n_eval_multiple: K1's full matrix, the compact rows taken)
        (208, 208, 10, 41, True),
    ]
    worst = {"K1": 0.0, "K2": 0.0}
    ok = True
    for kt in ("SqExp", "Ma5f2", "RatQu"):
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[-1]
            for n1, n2, d, B, same in cases:
                if max(n1, n2) >= 2000 and dt != torch.float64:
                    continue
                x1, x2, th, al, gb = _inputs(torch, rng, n1, n2, d, B, dt, kt,
                                             same)
                got = ca.kern_grad(kt, x1, x2, th, al)
                want = ca.kern_grad_plain(kt, x1, x2, th, al)
                g_got = ca.kern_grad_vjp_theta(kt, x1, x2, th, al, gb)
                g_want = ca.kern_grad_vjp_theta_plain(kt, x1, x2, th, al, gb)
                torch.cuda.synchronize()
                for name, a, b in (("K1", got, want), ("K2", g_got, g_want)):
                    abs_err = float((a - b).abs().max())
                    rel = abs_err / float(b.abs().max())
                    good = (a.shape == b.shape and bool(torch.isfinite(a).all())
                            and rel <= TOL[(name, dname)])
                    ok &= good
                    if dt == torch.float64 and (n1, n2, d) == (200, 200, 10):
                        worst[name] = max(worst[name], abs_err)
                    log(f"[check] {name} {kt:5s} {dname} n1={n1} n2={n2} d={d} "
                        f"B={B} max_abs={abs_err:.3e} rel={rel:.3e} "
                        f"tol={TOL[(name, dname)]:.0e} "
                        f"{'ok' if good else 'FAIL'}")
                del got, want, g_got, g_want, gb
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit("kernel check failed")
    # K2's partials are added in a fixed order, without atomics: the same
    # inputs give the same bits, so the MLL gradient repeats exactly
    for B in (None, 41):
        x1, _, th, _, gb = _inputs(torch, rng, 200, 200, 10, B, torch.float64,
                                   "SqExp", True)
        runs = [ca.kern_grad_vjp_theta("SqExp", x1, x1, th, None, gb)
                for _ in range(2)]
        same = torch.equal(runs[0], runs[1])
        log(f"[check] K2 SqExp float64 n=200 d=10 B={B} run twice: "
            f"{'bitwise equal' if same else 'DIFFER'}")
        if not same:
            raise SystemExit("K2 is not bitwise reproducible")
        del x1, th, gb, runs
    return worst


def _rosen_problem(rosenbrock, n, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (n, d))
    f, g = rosenbrock(x)
    x_test = rng.uniform(-2, 2, (128, d))
    f_test, g_test = rosenbrock(x_test)
    return x, f, g, x_test, f_test, g_test


def _fit(GaussianProcess, x, f, g, kernel_type="SqExp", wellcond="precon",
         device="cuda", calc_cond=False, **kw):
    """One refit through the facade, as a BO step makes it; with calc_cond
    the fitted model's condition number is computed too."""
    n, d = x.shape
    gp = GaussianProcess(d, True, kernel_type, wellcond, device=device, **kw)
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
    gp.set_hpara("optz", 0, calc_cond=calc_cond)
    return gp


def _counts(ca):
    return {"K1": ca.kern_grad.launches, "K2": ca.kern_grad_vjp_theta.launches}


def _path(torch, ca, name, fn, need=("K1", "K2")):
    """Drive one path with the launch counts set to 0 just before it and read
    just after; fails unless each kernel in ``need`` launched in it (a
    predict path runs no gradient, so no K2).  Returns fn's result, the
    path's wall seconds and its counts."""
    torch.cuda.synchronize()
    ca.reset_launches()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = _counts(ca)
    log(f"[path] {name}: {secs:.3f} s, launches K1 {counts['K1']} "
        f"K2 {counts['K2']}")
    if need and min(counts[k] for k in need) < 1:
        raise SystemExit(f"a kernel of the path '{name}' never launched")
    return res, secs, counts


def phase_main(torch, ca, GaussianProcess, rosenbrock):
    out = {}
    # d=10, n_eval=200: the size of the repo's d=10 BO traces
    d, n = 10, 200
    x, f, g, xt, ft, _ = _rosen_problem(rosenbrock, n, d)
    # the same fit twice, as bench.py does: the first pays the libraries'
    # start-up in this process, the second is the warm one a BO step sees
    _, t_first, _ = _path(torch, ca, "d=10 first fit",
                          lambda: _fit(GaussianProcess, x, f, g))

    def warm_fit_and_predict():
        t0 = time.perf_counter()
        gp = _fit(GaussianProcess, x, f, g)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        return gp, t_fit, gp.eval_model(xt, calc_grad=True)[:4]

    (gp, t_warm, pred), _, counts = _path(
        torch, ca, "d=10 warm fit + eval_model at 128 points",
        warm_fit_and_predict)
    h = gp.history
    tele = {k: float(getattr(h, k)[0]) for k in (
        "hp_optz_success", "hp_optz_iter_mean", "hp_optz_iter_max",
        "optz_n_cho_fail", "optz_max_init_cond", "Kcov_cond", "time_chofac")}
    mu, sig, dmu, dsig = pred
    finite = all(np.all(np.isfinite(a)) for a in (mu, sig, dmu, dsig))
    shapes = (mu.shape, sig.shape, dmu.shape, dsig.shape)
    rmse10 = float(np.sqrt(np.mean((mu - ft) ** 2)))
    log(f"[main] d={d} n_eval={n} n_data={(d + 1) * n} f64: first fit "
        f"{t_first:.3f} s, warm fit {t_warm:.3f} s, -lnL {-h.ln_lkd[0]:.10g}")
    log(f"[main] theta {np.array2string(np.asarray(gp.hp_vals.theta.cpu()), precision=4)}")
    log(f"[main] telemetry {json.dumps(tele)}")
    log(f"[main] eval_model 128 held-out: shapes {shapes} finite {finite} "
        f"rmse {rmse10:.6g} (std f_test {np.std(ft):.6g})")
    if not (finite and shapes == ((128,), (128,), (128, d), (128, d))
            and np.isfinite(h.ln_lkd[0])):
        raise SystemExit("main path d=10 output is not finite / misshapen")
    out.update(t_first=t_first, t_warm=t_warm, launches=counts,
               neg_lnL=-float(h.ln_lkd[0]), iters=tele["hp_optz_iter_max"])

    # RatQu at the same size: alpha is fitted, so each objective gradient
    # also runs the plain closed form's autograd for alpha on the card
    # (KernGradFn.backward).  Its warm fit time per K2 launch (one per
    # objective gradient) against SqExp's shows what that costs.
    for rep in ("first", "warm"):
        gp_rq, t_rq, c_rq = _path(
            torch, ca, f"d=10 RatQu {rep} fit",
            lambda: _fit(GaussianProcess, x, f, g, kernel_type="RatQu"))
    rq_ms = 1e3 * t_rq / c_rq["K2"]
    sq_ms = 1e3 * t_warm / counts["K2"]
    log(f"[main] RatQu d=10 warm fit {t_rq:.3f} s, -lnL "
        f"{-gp_rq.history.ln_lkd[0]:.10g}, alpha {float(gp_rq.hp_vals.kernel):.6g}:"
        f" {rq_ms:.2f} ms per objective gradient against SqExp's {sq_ms:.2f} ms")
    if not np.isfinite(gp_rq.history.ln_lkd[0]):
        raise SystemExit("RatQu d=10 fit is not finite")
    out.update(t_ratqu=t_rq, ratqu_launches=c_rq, ratqu_ms_per_grad=rq_ms,
               sqexp_ms_per_grad=sq_ms)

    # bench.py's problem and quality gate (bench.py:38-45, 458-465)
    d, n = 4, 64
    x, f, g, xt, ft, _ = _rosen_problem(rosenbrock, n, d)
    mu, t_bench, c_bench = _path(
        torch, ca, "bench problem d=4 n_eval=64 fit + predict",
        lambda: _fit(GaussianProcess, x, f, g).eval_model(xt)[0])
    rmse = float(np.sqrt(np.mean((mu - ft) ** 2)))
    gate = 0.01 * float(np.std(ft))
    log(f"[main] bench problem d=4 n_eval=64: rmse {rmse:.6g} gate {gate:.6g} "
        f"{'ok' if rmse < gate else 'FAIL'}")
    if not rmse < gate:
        raise SystemExit("bench-problem RMSE above the gate")
    out.update(rmse_bench=rmse, t_bench=t_bench, bench_launches=c_bench)

    # the card's path against the port's CPU path on small inputs: each
    # kernel family (RatQu also takes its alpha gradient on the card),
    # float32, the constrained and rescaling methods and trust-constr (at
    # cond_max 1e6, where its stopping point does not hang on last bits).
    # The fits may stop a few steps apart on a flat optimum, so -ln L is
    # compared to rtol 1e-6 (f32: 1e-3) and the predicted mean to 1e-4 of
    # its scale (f32: 1e-2).
    d, n = 3, 20
    x, f, g, xt, _, _ = _rosen_problem(rosenbrock, n, d, seed=1)
    cases = [("SqExp", "precon", "float64", {}),
             ("Ma5f2", "precon", "float64", {}),
             ("RatQu", "precon", "float64", {}),
             ("Ma5f2", "precon", "float32", {}),
             ("SqExp", "precon", "float32", {}),
             ("SqExp", "base", "float64", {}),
             ("SqExp", "rescale_origin", "float64", dict(cond_norm="fro")),
             ("Ma5f2", "dflt_vmin", "float64", {}),
             ("SqExp", "base", "float64",
              dict(optz_mtd="trust-constr", cond_max=1e6,
                   cond_max_target=1e6)),
             ("SqExp", "base", "float64", dict(use_grad=False))]
    bad = []
    for kt, wc, dt, extra in cases:
        kw = dict(dtype=dt, cond_max_target=1e6 if dt == "float32" else 1e10)
        kw.update(extra)
        use_grad = kw.pop("use_grad", True)
        label = f"small fit {kt} {wc} {dt} {json.dumps(extra)}"

        def fit_predict(dev):
            if use_grad:
                gp = _fit(GaussianProcess, x, f, g, kt, wc, device=dev, **kw)
            else:
                gp = GaussianProcess(d, False, kt, wc, device=dev, **kw)
                gp.init_optz_surr(2)
                gp.set_data(x, f, np.zeros(n))
                gp.set_hpara("optz", 0)
            return gp.history.ln_lkd[0], gp.eval_model(xt)[0]
        if use_grad:
            res_cuda = _path(torch, ca, label, lambda: fit_predict("cuda"))[0]
        else:
            # the gradient-free covariance is the plain closed form (as in
            # the JAX package): no K1 or K2 launch to count
            log(f"[path] {label}: gradient-free, outside the launch check")
            res_cuda = fit_predict("cuda")
        res = {"cuda": res_cuda, "cpu": fit_predict("cpu")}
        dl = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        dmu = float(np.max(np.abs(res["cuda"][1] - res["cpu"][1]))
                    / np.max(np.abs(res["cpu"][1])))
        tl, tm = (1e-3, 1e-2) if dt == "float32" else (1e-6, 1e-4)
        good = dl < tl and dmu < tm
        bad += [] if good else [label]
        log(f"[main] {label} d={d} n_eval={n}, card vs CPU path: lnL rel "
            f"{dl:.3e} (tol {tl:.0e}), mu rel {dmu:.3e} (tol {tm:.0e}) "
            f"{'ok' if good else 'FAIL'}")
    if bad:
        raise SystemExit(f"card path disagrees with the CPU path: {bad}")
    return out


CONSTRAINED = (  # conditioning method, options: the slice's two
    # configurations (the d=10 Baseline/Rescaling traces run 'fro')
    ("base", {}),
    ("rescale_origin", {"cond_norm": "fro"}),
)


def phase_constrained(torch, ca, GaussianProcess, rosenbrock):
    """The slice's constrained fits at the main path's width (d=10,
    n_eval=200, f64), each followed by prediction with gradients at 128
    held-out points.  Returns {name: results}."""
    from gpgradpy_torch.fit import scipy_driver
    d, n = 10, 200
    x, f, g, xt, ft, _ = _rosen_problem(rosenbrock, n, d)
    out = {}
    for name, kw in CONSTRAINED:
        def fit_predict():
            t0 = time.perf_counter()
            gp = _fit(GaussianProcess, x, f, g, wellcond=name,
                      calc_cond=True, **kw)
            torch.cuda.synchronize()
            t_fit = time.perf_counter() - t0
            return gp, t_fit, gp.eval_model(xt, calc_grad=True)[:4]

        (gp, t_fit, pred), secs, counts = _path(
            torch, ca, f"d=10 {name} fit + eval_model at 128 points",
            fit_predict)
        h, infos = gp.history, gp.optz_infos
        calls = {k: int(sum(i[k] for i in infos)) for k in (
            "optz_n_val", "optz_n_grad", "optz_n_cond", "optz_n_cond_grad")}
        # one start per inner fit: its iterations are the fit's
        iters = [int(i["hp_optz_iter_max"]) for i in infos]
        cond, cmax = float(h.Kcov_cond[0]), gp.cfg.cond_max
        mu, sig, dmu, dsig = pred
        finite = all(np.all(np.isfinite(a)) for a in (mu, sig, dmu, dsig))
        shapes_ok = (mu.shape, sig.shape, dmu.shape, dsig.shape) == (
            (128,), (128,), (128, d), (128, d))
        rmse = float(np.sqrt(np.mean((mu - ft) ** 2)))
        xs = None if gp.DataScl is None else gp.DataScl.xvec_scale.tolist()
        r = dict(fit_s=t_fit, path_s=secs, launches=counts,
                 slsqp_iters=iters, calls=calls, cond=cond, cond_max=cmax,
                 model_cond=gp.condK, neg_lnL=-float(h.ln_lkd[0]),
                 xvec_scale=xs, finite=finite, rmse=rmse,
                 theta=np.asarray(gp.hp_vals.theta.cpu()).tolist())
        out[name] = r
        log(f"[constrained] {name} d={d} n_eval={n} f64 "
            f"cond_norm={gp.cfg.cond_norm}: fit {t_fit:.3f} s, SLSQP "
            f"iterations {iters} (one per inner fit), calls {json.dumps(calls)}")
        log(f"[constrained] {name}: cond at the optimum {cond:.6g} "
            f"(cond_max {cmax:.0e}, limit 1.01 cond_max), final model's cond "
            f"{gp.condK:.6g}, -lnL {r['neg_lnL']:.10g}, xvec_scale {xs}")
        log(f"[constrained] {name}: eval_model 128 held-out with gradients: "
            f"finite {finite} shapes {'ok' if shapes_ok else 'WRONG'} rmse "
            f"{rmse:.6g} (std f_test {np.std(ft):.6g}); K1 {counts['K1']} "
            f"K2 {counts['K2']} launches")
        if not (finite and shapes_ok and cond <= 1.01 * cmax
                and np.isfinite(h.ln_lkd[0])):
            raise SystemExit(f"constrained fit '{name}' broke its constraint "
                             f"or gave a non-finite / misshapen output")
        # one callback evaluation of each kind at the optimum (MLL + cond
        # from one forward; with gradients, both backward passes), on the
        # host clock around calls that end in their copy to the host
        v = gp._prev_hp_vec()
        r["eval_ms"] = {}
        for kind, with_grad in (("value", False), ("value+gradient", True)):
            def one():
                return scipy_driver.evaluate(
                    gp.cfg, gp.spec, gp.hp_info_optz_lkd, gp.data,
                    float(gp._etaK), v, True, True, with_grad)
            one()
            t0 = time.perf_counter()
            for _ in range(5):
                one()
            r["eval_ms"][kind] = (time.perf_counter() - t0) / 5 * 1e3
        log(f"[constrained] {name}: one evaluation at the optimum: value + "
            f"cond {r['eval_ms']['value']:.2f} ms, with both gradients "
            f"{r['eval_ms']['value+gradient']:.2f} ms")
    return out


# the JAX facade tests' conditioning for the iterative solver
# (tests/test_facade_iterative.py:34): diagonal-preconditioned CG converges
# at cond_max_target 1e6, not at the dense default 1e10
ITER_COND = dict(cond_max_target=1e6, cond_max=1e6)
# the CG cap of the predict checks: at the default iter_max_cg (1024) CG
# stops short of iter_cg_tol at the fitted theta (PERF.md); the cap
# only bounds the loop, which ends once every column has converged
PREDICT_MAX_CG = 8192
# the default-cap predict at the BO size (CG stopped at 1024 iterations)
# against the dense one, in multiples of ITER_PRED_TOL for mu, sig, dmu,
# dsig.  A capped CG gives round-off's answer, which moves from run to run
# and between the two packages: the largest excesses measured, on the card
# and for both packages on the CPU, are 2948, 24.5, 35723 and 478 (PERF.md
# section 6; tests/test_torch_iterative.py run as a script).  Ten times
# those, so that a default path gone worse by an order of magnitude fails.
DEFAULT_CAP_EXCESS = (3e4, 3e2, 4e5, 5e3)
MATVEC_TOL = {  # max |KernMatvecFn - plain| / max |plain|, on the card
    # forward: K1's few ulp of max|K|, then a product over 2211 terms in the
    # same order (the f32 bound is K1's 2e-6 grown by that sum)
    ("forward", "float64"): 1e-12, ("forward", "float32"): 1e-4,
    # theta gradient: K2's tolerances (a sum of (1+d)^2 n1 n2 terms per tile)
    ("theta", "float64"): 1e-10, ("theta", "float32"): 1e-3,
}


class CgLog:
    """Records each mbcg call made inside the block: (right-hand sides,
    iterations, largest final relative residual).  Reading them back costs
    one sync per solve."""

    def __init__(self, iterative):
        self.it, self.calls = iterative, []

    def __enter__(self):
        self.orig = orig = self.it.mbcg

        def record(*a, **kw):
            res = orig(*a, **kw)
            self.calls.append((res.X.shape[1], int(res.n_iter),
                               float(res.residnorm.max())))
            return res
        self.it.mbcg = record
        return self

    def __exit__(self, *exc):
        self.it.mbcg = self.orig

    def text(self):
        return ", ".join(f"{m} rhs: {k} it, resid {r:.2e}"
                         for m, k, r in self.calls)


def _masked_problem(torch, tgp, rng, n, d, kt, dt):
    """A noisy partial-gradient dataset on the card (every third point
    without gradients) and its hyperparameters."""
    bvec = np.arange(n) % 3 != 1
    x = rng.uniform(-2, 2, (n, d))

    def t(a):
        return torch.as_tensor(a, dtype=dt, device="cuda")
    spec = tgp.make_data_spec(d, True, n, std_fval=np.full(n, 0.05),
                              std_grad=np.full((int(bvec.sum()), d), 0.05),
                              bvec_use_grad=bvec)
    data = tgp.GpData(x=t(x), fval=t(rng.standard_normal(n)),
                      std_fval=t(np.full(n, 0.05)),
                      grad=t(rng.standard_normal((int(bvec.sum()), d))),
                      std_grad=t(np.full((int(bvec.sum()), d), 0.05)))
    cfg = tgp.GpConfig(dim=d, kernel_type=kt,
                       dtype="float64" if dt == torch.float64 else "float32")
    return cfg, spec, data


def phase_matvec_check(torch, ca, it, tli, tgp):
    """KernMatvecFn (K1 per row tile + product; K2 per tile in the theta
    backward) against the plain kern_matvec on the same card tensors:
    forward and the theta gradient of sum(G * K(theta) V), 3 families
    (RatQu at alpha 1.7) x f64/f32, n_eval=201 in row tiles of 64 (a ragged
    last tile), d=10; the full layout alone (also as one tile of 256, the
    BO size's case), then the masked partial-gradient layout with its
    noise and eta extras.  Also checks one K1 launch per tile forward and
    one K2 per tile backward.  Returns
    the f64 SqExp full-layout errors."""
    rng = np.random.default_rng(2)
    n, d, rb = 201, 10, 64
    n_tiles = -(-n // rb)
    N = n * (1 + d)
    worst, ok = {}, True
    for kt in ("SqExp", "Ma5f2", "RatQu"):
        for dt in (torch.float64, torch.float32):
            dname = str(dt).split(".")[-1]
            cfg, spec, data = _masked_problem(torch, tgp, rng, n, d, kt, dt)
            x = data.x
            th0 = torch.as_tensor(10.0 ** rng.uniform(-2, 0, d), dtype=dt,
                                  device="cuda")
            al = (torch.tensor(1.7, dtype=dt, device="cuda")
                  if kt == "RatQu" else None)
            V = torch.as_tensor(rng.standard_normal((N, 3)), dtype=dt,
                                device="cuda")
            G = torch.as_tensor(rng.standard_normal((N, 3)), dtype=dt,
                                device="cuda")
            pieces = tli._iter_setup(cfg, spec, data, 1e-3, rb)
            m = pieces.mask[:, None]

            def hp(t):
                return tgp.Hypers(theta=t, kernel=al,
                                  varK=torch.tensor(2.0, dtype=dt,
                                                    device="cuda"))
            layouts = {  # name: (matvec, its plain version, K1/K2 launches)
                "full": (lambda t: it.kern_matvec(kt, x, t, al, V,
                                                  row_block=rb),
                         lambda t: it.kern_matvec_plain(kt, x, t, al, V, rb),
                         n_tiles),
                "1-tile": (lambda t: it.kern_matvec(kt, x, t, al, V,
                                                    row_block=256),
                           lambda t: it.kern_matvec_plain(kt, x, t, al, V,
                                                          256), 1),
                "masked": (lambda t: pieces.mv_hp(hp(t), V),
                           lambda t: m * (it.kern_matvec_plain(
                               kt, x, t, al, m * V, rb)
                               + pieces.extra_hp(hp(t))[:, None] * m * V)
                           + (1.0 - m) * V, n_tiles),
            }
            for layout, (mv, plain, launches) in layouts.items():
                torch.cuda.synchronize()
                ca.reset_launches()
                t = th0.clone().requires_grad_(True)
                got = mv(t)
                k1 = ca.kern_grad.launches
                g_got, = torch.autograd.grad((G * got).sum(), t)
                got, want = got.detach(), None
                torch.cuda.synchronize()
                k2 = ca.kern_grad_vjp_theta.launches
                tp = th0.clone().requires_grad_(True)
                want = plain(tp)
                g_want, = torch.autograd.grad((G * want).sum(), tp)
                want = want.detach()
                errs = {
                    "forward": float((got - want).abs().max()
                                     / want.abs().max()),
                    "theta": float((g_got - g_want).abs().max()
                                   / g_want.abs().max())}
                good = (all(errs[k] <= MATVEC_TOL[(k, dname)] for k in errs)
                        and k1 == launches and k2 == launches)
                ok &= good
                if (kt, dname, layout) == ("SqExp", "float64", "full"):
                    worst = dict(errs, max_abs=float((got - want).abs().max()))
                log(f"[matvec] {kt:5s} {dname} {layout:6s} n_eval={n} d={d} "
                    f"row_block={rb}: forward rel {errs['forward']:.2e} "
                    f"(tol {MATVEC_TOL[('forward', dname)]:.0e}), theta "
                    f"rel {errs['theta']:.2e} (tol "
                    f"{MATVEC_TOL[('theta', dname)]:.0e}), K1 {k1} K2 {k2} "
                    f"launches ({launches} tiles) {'ok' if good else 'FAIL'}"
                    + (" [TF32 off]" if dt == torch.float32 else ""))
    # the CG loop's vector update as a CUDA-graph replay against the eager
    # update, on the masked f64 SqExp system at this size: same kernels on
    # the same buffers, so the same bits
    cfg, spec, data = _masked_problem(torch, tgp, rng, n, d, "SqExp",
                                      torch.float64)
    hp = tgp.Hypers(theta=torch.full((d,), 0.05, dtype=torch.float64,
                                     device="cuda"),
                    varK=torch.tensor(2.0, dtype=torch.float64, device="cuda"))
    pieces = tli._iter_setup(cfg, spec, data, 1e-3, rb)
    dg = 1.0 / pieces.diag_hp(hp)
    B = torch.as_tensor(rng.standard_normal((N, 17)), device="cuda")
    runs = {}
    for graph in (False, True, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = it.mbcg(lambda V: pieces.mv_hp(hp, V), B, max_iters=1024,
                      tol=1e-10, M_inv_diag=dg, graph=graph)
        k = int(res.n_iter)
        runs[graph] = (res, k, (time.perf_counter() - t0) / k * 1e3)
    (r_e, k_e, ms_e), (r_g, k_g, ms_g) = runs[False], runs[True]
    same = (k_e == k_g and torch.equal(r_e.X, r_g.X)
            and torch.equal(r_e.alphas, r_g.alphas)
            and torch.equal(r_e.betas, r_g.betas))
    log(f"[matvec] CG, 17 rhs, masked f64 n_eval={n} d={d}: {k_g} "
        f"iterations, residual {float(r_g.residnorm.max()):.2e}; graphed "
        f"update {ms_g:.4f} ms per iteration against eager {ms_e:.4f} ms "
        f"(host wall): {'bitwise equal' if same else 'DIFFER'}")
    if not (ok and same):
        raise SystemExit("matrix-free matvec / CG check failed")
    return dict(worst, cg_ms_per_iter={"graph": ms_g, "eager": ms_e},
                cg_iters=k_g)


def phase_iterative(torch, ca, it, GaussianProcess, rosenbrock):
    """[iterative] at the BO size: a facade fit with solver='iterative'
    (d=10, n_eval=200, SqExp, f64, ITER_COND, default iter_* options), the
    dense port fit of the same data (the dense -ln L at the iterative
    hyperparameters within max(2, 0.02 |f|) of the dense optimum, the JAX
    criterion of tests/test_facade_iterative.py:94), then eval_model with
    gradients at 128 points against the dense facade at the same
    hyperparameters: the fit's own model (CG capped at the default 1024,
    held to DEFAULT_CAP_EXCESS times the tolerances), then the model set
    up again at the fit's theta with CG run to its tolerance (held to
    tests/test_facade_iterative.py:69-72's tolerances, every solve
    converged)."""
    d, n = 10, 200
    x, f, g, xt, ft, _ = _rosen_problem(rosenbrock, n, d)

    def fit_iter():
        t0 = time.perf_counter()
        gp = _fit(GaussianProcess, x, f, g, solver="iterative", **ITER_COND)
        torch.cuda.synchronize()
        return gp, time.perf_counter() - t0

    (gp_i, t_fit), _, c_fit = _path(
        torch, ca, "[iterative] d=10 n_eval=200 fit", fit_iter)
    info = gp_i.optz_infos[0]
    fit_cfg = gp_i.cfg
    theta = gp_i.hp_vals.theta.cpu().numpy()
    log(f"[iterative] fit d={d} n_eval={n} f64 cond_max_target 1e6: "
        f"{t_fit:.3f} s, L-BFGS iterations {info['hp_optz_iter_max']:.0f} "
        f"(2 starts, mean {info['hp_optz_iter_mean']:.1f}), objective "
        f"evaluations {info['optz_n_val']}, CG at the optimum "
        f"{info['iter_cg_iters']} iterations, residual "
        f"{info['iter_cg_resid']:.2e}, K1 {c_fit['K1']} K2 {c_fit['K2']} "
        f"launches ({c_fit['K1'] / info['optz_n_val']:.0f} K1 per objective);"
        f" the host reads CG convergence every {it.CHECK_EVERY} iterations")

    t0 = time.perf_counter()
    gp_d = _fit(GaussianProcess, x, f, g, **ITER_COND)
    t_dense = time.perf_counter() - t0
    f_d = -float(gp_d.calc_lkd_all(gp_d.hp_vals)[0].ln_lkd)
    f_i = -float(gp_d.calc_lkd_all(gp_i.hp_vals)[0].ln_lkd)
    margin = max(2.0, 0.02 * abs(f_d))
    fit_ok = bool(np.isfinite(f_i) and f_i <= f_d + margin)
    log(f"[iterative] dense -lnL at the iterative theta {f_i:.10g} against "
        f"the dense fit's optimum {f_d:.10g} (dense fit {t_dense:.3f} s): "
        f"excess {f_i - f_d:.4g} <= {margin:.4g} {'ok' if fit_ok else 'FAIL'}")

    log(f"[iterative] theta {np.array2string(theta, precision=6)}")
    gp_s = GaussianProcess(d, True, "SqExp", "precon", **ITER_COND)
    gp_s.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
    gp_s.set_custom_hp(theta=theta)
    gp_s.set_hpara("current", 0)
    pred_d = gp_s.eval_model(xt, calc_grad=True)[:4]

    # the fitted model as the fit left it (iter_max_cg 1024), then set up
    # again at the same theta with the cap raised so CG reaches its tolerance
    with CgLog(it) as cg_default:
        pred_1024, t_1024, _ = _path(
            torch, ca, "[iterative] eval_model 128 points, fit's model",
            lambda: gp_i.eval_model(xt, calc_grad=True)[:4], need=("K1",))
    state = gp_i._eval_state
    cap_ok, cap_err = _compare(pred_1024, pred_d, ITER_PRED_TOL,
                               DEFAULT_CAP_EXCESS)
    log(f"[iterative] at iter_max_cg 1024: setup CG {int(state.cg_iters)} "
        f"iterations, residual {float(state.cg_resid):.2e}; predict CG "
        f"{cg_default.text()}; vs dense: {cap_err} "
        f"{'ok' if cap_ok else 'FAIL'}")

    def predict_converged():
        gp_i.iter_max_cg = PREDICT_MAX_CG
        gp_i.set_custom_hp(theta=theta)
        gp_i.set_hpara("current", 0)
        return gp_i.eval_model(xt, calc_grad=True)[:4]
    with CgLog(it) as cg_pred:
        pred_i, t_pred, c_pred = _path(
            torch, ca, f"[iterative] closed form + setup + eval_model 128 "
            f"points, iter_max_cg {PREDICT_MAX_CG}", predict_converged,
            need=("K1",))
    pred_ok, pred_err = _compare(pred_i, pred_d, ITER_PRED_TOL)
    converged = all(r < gp_i.cfg.iter_cg_tol for _, _, r in cg_pred.calls)
    log(f"[iterative] iter_max_cg {PREDICT_MAX_CG}: CG {cg_pred.text()} "
        f"({t_pred:.3f} s); vs the dense facade at the same theta: "
        f"{pred_err} {'ok' if pred_ok else 'FAIL'}; converged {converged}")
    if not (fit_ok and pred_ok and cap_ok and converged):
        raise SystemExit("[iterative] path fails the dense criterion or "
                         "its CG did not converge")
    return dict(fit_cfg=fit_cfg, fit_s=t_fit, dense_fit_s=t_dense,
                lbfgs_iters=info[
        "hp_optz_iter_max"], objective_evals=info["optz_n_val"],
        cg_iters=info["iter_cg_iters"], cg_resid=info["iter_cg_resid"],
        fit_launches=c_fit, predict_launches=c_pred, predict_s=t_pred,
        cg_predict=cg_pred.calls, cg_predict_1024=cg_default.calls,
        neg_lnL_dense_at_iter=f_i, neg_lnL_dense_opt=f_d,
        theta=theta.tolist(), gp=gp_i)


# mu, sig, dmu, dsig: (rtol, atol) of the JAX facade's iterative-vs-dense
# test (tests/test_facade_iterative.py:69-72) and of its large-n test
# (:234-235, mu and sig only)
ITER_PRED_TOL = ((1e-7, 1e-9), (1e-5, 1e-9), (1e-6, 1e-7), (1e-4, 1e-7))
LARGE_PRED_TOL = ((1e-6, 1e-8), (1e-4, 1e-8))


def _compare(got, want, tols, limits=(1.0,) * 4):
    """allclose of each pair at its (rtol, atol), the excess held to its
    limit (1: allclose itself); returns (ok, text)."""
    ok, parts = True, []
    for name, a, b, (rtol, atol), lim in zip(
            ("mu", "sig", "dmu", "dsig"), got, want, tols, limits):
        excess = float(np.max(np.abs(a - b) / (atol + rtol * np.abs(b))))
        ok &= excess <= lim
        parts.append(f"{name} max|d| {np.max(np.abs(a - b)):.2e} "
                     f"({excess:.2f} of rtol {rtol:.0e} atol {atol:.0e}"
                     + ("" if lim == 1.0 else f", limit {lim:.0e}") + ")")
    return ok, "; ".join(parts)


def phase_iterative_large(torch, ca, it, tli, GaussianProcess, rosenbrock,
                          theta):
    """[iterative-large]: d=10, n_eval=2000 (N = 22 000), f64, ITER_COND,
    at the BO-size fit's theta (a fit at this size is cut: each objective
    sweep would take minutes).  set_custom_hp -> set_hpara('current') ->
    eval_model with gradients at 128 points (CG capped at PREDICT_MAX_CG)
    against the dense facade at the same theta; one timed
    neg_mll_iterative_and_grad with the default options; CG iterations
    and residual of each solve; K1/K2 launches; peak device memory of the
    iterative and of the dense predict."""
    from gpgradpy_torch.fit.iterative_driver import iter_kw
    d, n = 10, 2000
    x, f, g, xt, _, _ = _rosen_problem(rosenbrock, n, d, seed=2)

    def make(solver):
        gp = GaussianProcess(d, True, "SqExp", "precon", solver=solver,
                             iter_max_cg=PREDICT_MAX_CG, **ITER_COND)
        gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
        gp.set_custom_hp(theta=theta)
        gp.set_hpara("current", 0)
        return gp

    def predict(solver):
        gp = make(solver)
        return gp, gp.eval_model(xt, calc_grad=True)[:4]

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with CgLog(it) as cg_pred:
        (gp_i, pred_i), t_i, c_i = _path(
            torch, ca, "[iterative-large] setup + eval_model 128 points",
            lambda: predict("iterative"), need=("K1",))
    peak_i = torch.cuda.max_memory_allocated()
    log(f"[iterative-large] n_eval={n} d={d} N={n * (d + 1)}: setup + "
        f"predict {t_i:.3f} s, CG solves: {cg_pred.text()}")

    # one objective as a fit runs it: the default iter_* options
    cfg = gp_i.cfg.replace(iter_max_cg=1024)
    z = it.rademacher(n * (d + 1), cfg.iter_n_probes, 1, torch.float64,
                      "cuda")
    hp = gp_i.hp_vals._replace(beta=None, varK=None)
    with CgLog(it) as cg_obj:
        (val, gth, lkd), t_obj, c_obj = _path(
            torch, ca, "[iterative-large] one neg_mll_iterative_and_grad",
            lambda: tli.neg_mll_iterative_and_grad(
                cfg, gp_i.spec, gp_i.data, hp, float(gp_i._etaK), z,
                **iter_kw(cfg)))
    log(f"[iterative-large] one objective + gradient {t_obj:.3f} s: -lnL "
        f"{float(val):.10g}, |grad| {float(gth.norm()):.4g}, CG solves: "
        f"{cg_obj.text()}")
    del gp_i, z, hp, gth
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, pred_d = predict("dense")
    torch.cuda.synchronize()
    t_d = time.perf_counter() - t0
    peak_d = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    ok, err = _compare(pred_i[:2], pred_d[:2], LARGE_PRED_TOL)
    converged = all(r < cfg.iter_cg_tol for _, _, r in cg_pred.calls)
    log(f"[iterative-large] vs the dense facade (setup + predict {t_d:.3f} "
        f"s): {err} {'ok' if ok else 'FAIL'}; every predict CG solve "
        f"(iter_max_cg {PREDICT_MAX_CG}) converged: {converged}")
    log(f"[iterative-large] peak device memory: iterative setup + predict "
        f"{peak_i / 2 ** 30:.2f} GiB, dense setup + predict "
        f"{peak_d / 2 ** 30:.2f} GiB")
    if not (ok and converged):
        raise SystemExit("[iterative-large] predict disagrees with dense or "
                         "its CG did not converge")
    return dict(predict_s=t_i, dense_predict_s=t_d, objective_s=t_obj,
                predict_launches=c_i, objective_launches=c_obj,
                cg_predict=cg_pred.calls, cg_objective=cg_obj.calls,
                peak_gib={"iterative": peak_i / 2 ** 30,
                          "dense": peak_d / 2 ** 30},
                cg_converged=converged, neg_lnL=float(val))


def profile_iter_objective(torch, it, tli, gp, cfg):
    """One neg_mll_iterative_and_grad at the BO-size fit's optimum, with the
    fit's options ``cfg``, under the profiler (after one warm run, whose CG
    solves are printed): device time by layer and the idle share."""
    from gpgradpy_torch.fit.iterative_driver import iter_kw
    z = it.rademacher(gp.spec.n_eval * (1 + gp.spec.dim), cfg.iter_n_probes,
                      1, torch.float64, "cuda")
    hp = gp.hp_vals._replace(beta=None, varK=None)

    def objective():
        return tli.neg_mll_iterative_and_grad(cfg, gp.spec, gp.data, hp,
                                              float(gp._etaK), z,
                                              **iter_kw(cfg))
    with CgLog(it) as cg:
        objective()
    log(f"[profile] iterative objective d=10 n_eval=200, CG solves: "
        f"{cg.text()}")
    return profile_fn(torch, "one iterative objective + gradient d=10 "
                      "n_eval=200", objective, ITER_GROUPS)


def phase_iterative_card_vs_cpu(torch, ca, GaussianProcess):
    """Iterative fits on the card and on the CPU with the same seed, hence
    the same probes (drawn on the CPU): 'precon' at d=2, n_eval=40 and the
    rescale fixed-point loop ('rescale_origin') at n_eval=16.  -ln L agrees
    to rtol 1e-6, the bound of the dense small fits above (the two runs'
    sums differ in the last bits, CG and the L-BFGS carry that on).  At
    cond_max_target 1e4, where CG takes ~150 iterations, not ~750.  On the
    card's 'precon' model, eval_model_var and make_predict_fn are held to
    eval_model (rtol 1e-12)."""
    out = {}
    for wellcond, n in (("precon", 40), ("rescale_origin", 16)):
        rng = np.random.default_rng(0)
        x = rng.uniform(-1.5, 1.5, (n, 2))
        f = np.sum(x ** 2, axis=1) + 0.5 * np.sin(3.0 * x[:, 0]) * x[:, 1]
        g = 2.0 * x
        g[:, 0] += 1.5 * np.cos(3.0 * x[:, 0]) * x[:, 1]
        g[:, 1] += 0.5 * np.sin(3.0 * x[:, 0])
        xq = rng.uniform(-1.4, 1.4, (7, 2))
        res = {}
        for dev in ("cuda", "cpu"):
            def fit():
                t0 = time.perf_counter()
                gp = _fit(GaussianProcess, x, f, g, wellcond=wellcond,
                          device=dev, solver="iterative",
                          cond_max_target=1e4, cond_max=1e4)
                return gp, time.perf_counter() - t0
            if dev == "cuda":
                (gp, secs), _, _ = _path(
                    torch, ca, f"[iterative] {wellcond} d=2 n_eval={n} card "
                    f"fit", fit)
                gp_card = gp
            else:
                gp, secs = fit()
            res[dev] = (float(gp.history.ln_lkd[0]), secs, len(gp.optz_infos),
                        sum(i["optz_n_val"] for i in gp.optz_infos))
        rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        good = rel <= 1e-6
        log(f"[iterative] {wellcond} d=2 n_eval={n} fit, card vs CPU: lnL "
            f"{res['cuda'][0]:.12g} vs {res['cpu'][0]:.12g}, rel {rel:.3e} "
            f"(tol 1e-6), {res['cuda'][1]:.2f} s / {res['cpu'][1]:.2f} s, "
            f"inner fits {res['cuda'][2]} / {res['cpu'][2]}, evaluations "
            f"{res['cuda'][3]} / {res['cpu'][3]} {'ok' if good else 'FAIL'}")
        if wellcond == "precon":
            mu, sig, dmu, dsig = gp_card.eval_model(xq, calc_grad=True)[:4]
            var, dvar, _ = gp_card.eval_model_var(xq, calc_grad=True)
            served = gp_card.make_predict_fn(calc_grad=True)(xq)
            pairs = [(var, sig ** 2), (dvar, 2.0 * sig[:, None] * dsig)] + [
                (t.cpu().numpy(), a) for t, a in zip(served, (mu, sig, dmu,
                                                              dsig))]
            same = all(np.allclose(a, b, rtol=1e-12, atol=0) for a, b in pairs)
            log(f"[iterative] card eval_model_var and make_predict_fn "
                f"against eval_model: {'ok' if same else 'FAIL'}")
            good &= same
        if not good:
            raise SystemExit(f"iterative card fit ({wellcond}) disagrees with "
                             f"the CPU fit or its own predict")
        out[wellcond] = dict(rel=rel, card_s=res["cuda"][1],
                             cpu_s=res["cpu"][1])
    return out


# ---------------------------------------------------------------------------
# hyperparameter inference: NUTS, ADVI, SMC over make_gp_logpost
# ---------------------------------------------------------------------------

# the slice's NUTS run at full width (d=10, n_eval=200, f64, 8 chains, the
# facade's default), with warmup, samples and tree depth cut so that the
# phase stays within ~150 s on one H100: a leapfrog of 8 chains takes ~80
# ms and a tree of depth 5 (31 leapfrogs) ~2.5 s (PERF.md section 6)
NUTS_D10 = dict(n_chains=8, n_warmup=40, n_samples=20, max_depth=5, seed=0)
# bench.py's NUTS configuration (bench.py:350-392) at its width, in float64
# at cond_max_target 1e10 as bench.py runs it on the CPU, its transitions
# cut from 64 + 128 to 32 + 64 to keep the whole script under 900 s on a
# slow host (the phase is host-bound: 140-226 s uncut).  bench.py times a
# second run because its first one compiles; the port compiles nothing,
# so it runs once
NUTS_256 = dict(n_chains=256, n_warmup=32, n_samples=64, max_depth=6)
SMALL_N, SMALL_D = 32, 2


class StepLog:
    """Inside the block, records the wall time (after a sync) at the end of
    each nuts_step call, and each leapfrog's batch (the chains evaluated in
    one lockstep leaf)."""

    def __init__(self, torch, nuts):
        self.torch, self.nuts = torch, nuts
        self.t_end, self.rows = [], []

    def __enter__(self):
        self.orig = self.nuts.nuts_step, self.nuts._leapfrog
        step, leapfrog = self.orig

        def step_rec(*a, **kw):
            out = step(*a, **kw)
            self.torch.cuda.synchronize()
            self.t_end.append(time.perf_counter())
            return out

        def leapfrog_rec(lg, inv_mass, *a):
            self.rows.append(inv_mass.shape[0])
            return leapfrog(lg, inv_mass, *a)
        self.nuts.nuts_step, self.nuts._leapfrog = step_rec, leapfrog_rec
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.nuts.nuts_step, self.nuts._leapfrog = self.orig

    def sampling_s(self, n_samples):
        """Wall seconds of the last n_samples transitions."""
        return self.t_end[-1] - self.t_end[-n_samples - 1]


def _state_at(torch, nuts, lg, z, diag, seed):
    """A NutsState of the adapted chains at z (the profiled transitions)."""
    B = z.shape[0]
    lp, g = lg(z)
    return nuts.NutsState(
        z=z, logp=lp, grad=g,
        step=torch.as_tensor(diag["step_size"], device="cuda"),
        inv_mass=torch.as_tensor(diag["inv_mass"], device="cuda"),
        rng=nuts.Draws(seed, "cuda"), accept_prob=torch.zeros_like(lp),
        diverging=torch.zeros(B, dtype=torch.bool, device="cuda"),
        n_leapfrog=torch.zeros(B, dtype=torch.int64, device="cuda"))


def _max_rel(a, b):
    """max |a - b| / |b| over the entries (np.allclose's relative form)."""
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def phase_nuts_d10(torch, ca, GaussianProcess, rosenbrock):
    """[nuts-d10]: sample_posterior on the d=10, n_eval=200 fit (SqExp,
    precon, f64; N = 2200 covariance rows) with 8 chains at NUTS_D10.
    Times one batched leapfrog (B=8) first; holds make_gp_logpost's value
    and gradient at a batch of z on the card to the port's CPU path (rtol
    1e-9 / 1e-6); then samples, and fails unless every sample is finite,
    the divergence share over sampling is below 0.05 and the median log10
    theta lies within 0.6 of the MAP in each dimension (the JAX criterion,
    tests/test_api_extras.py:22-31)."""
    from gpgradpy_torch.fit import multistart
    from gpgradpy_torch.inference import diagnostics, nuts
    from gpgradpy_torch.types import GpData
    f64 = torch.float64
    d, n = 10, 200
    x, f, g, _, _, _ = _rosen_problem(rosenbrock, n, d)
    gp = _fit(GaussianProcess, x, f, g)
    cfg, spec, info = gp.cfg, gp.spec, gp.hp_info_optz_lkd
    bounds = multistart.get_hp_bounds(cfg, info, gp.history, 0)
    eta = float(gp._etaK)
    args = (cfg, spec, info, gp.data, eta, bounds.box_lb, bounds.box_ub)
    logpost, z_to_hp, hp_to_z = nuts.make_gp_logpost(*args)
    lg = nuts.value_and_grad(logpost)
    log_map = np.log10(gp.hp_vals.theta.cpu().numpy())
    z_map = hp_to_z(torch.as_tensor(log_map, dtype=f64, device="cuda"))
    B = NUTS_D10["n_chains"]
    z8 = z_map + 0.02 * nuts.Draws(1, "cuda").normal((B, info.n_hp), f64)
    r8 = torch.ones_like(z8)
    step = torch.full((B,), 0.01, dtype=f64, device="cuda")
    _, g8 = lg(z8)
    ca.reset_launches()
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        nuts._leapfrog(lg, torch.ones_like(z8), step, z8, r8, g8)
    torch.cuda.synchronize()
    lf_ms = (time.perf_counter() - t0) / reps * 1e3
    log(f"[nuts-d10] one batched leapfrog (value + gradient of {B} chains, "
        f"N = {(d + 1) * n}): {lf_ms:.2f} ms ({lf_ms / B:.2f} ms per chain);"
        f" K1 {ca.kern_grad.launches} K2 {ca.kern_grad_vjp_theta.launches} "
        f"launches in {reps} leapfrogs")

    # the card against the port's CPU path at one batch of z
    zb = z8[:2]
    data_cpu = GpData(*(None if t is None else t.cpu() for t in gp.data))
    logpost_cpu = nuts.make_gp_logpost(cfg, spec, info, data_cpu, eta,
                                       bounds.box_lb, bounds.box_ub)[0]
    v_c, g_c = lg(zb)
    t0 = time.perf_counter()
    v_h, g_h = nuts.value_and_grad(logpost_cpu)(zb.cpu())
    t_cpu = time.perf_counter() - t0
    rel_v = _max_rel(v_c.cpu(), v_h)
    rel_g = _max_rel(g_c.cpu(), g_h)
    lp_ok = rel_v <= 1e-9 and rel_g <= 1e-6
    log(f"[nuts-d10] make_gp_logpost at {zb.shape[0]} z rows, card vs CPU "
        f"path: value rel {rel_v:.3e} (tol 1e-9), gradient rel {rel_g:.3e} "
        f"(tol 1e-6) {'ok' if lp_ok else 'FAIL'}; the CPU path took "
        f"{t_cpu:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    with StepLog(torch, nuts) as sl:
        (samples, diag), secs, counts = _path(
            torch, ca, f"[nuts-d10] sample_posterior {json.dumps(NUTS_D10)}",
            lambda: gp.sample_posterior(**NUTS_D10))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    W, S = NUTS_D10["n_warmup"], NUTS_D10["n_samples"]
    t_samp = sl.sampling_s(S)
    rate = B * S / t_samp
    lf = diag["n_leapfrog"]
    rows = np.asarray(sl.rows)
    log_s = np.log10(samples)
    st = torch.as_tensor(log_s)
    rhat = diagnostics.split_rhat(st).numpy()
    ess = diagnostics.effective_sample_size(st).numpy()
    div = float(np.mean(diag["diverging"]))
    med_off = np.abs(np.median(log_s.reshape(-1, info.n_hp), 0) - log_map)
    finite = bool(np.all(np.isfinite(samples)))
    log(f"[nuts-d10] depth cut: n_warmup {W}, n_samples {S}, max_depth "
        f"{NUTS_D10['max_depth']} (the facade's defaults: 400, 400, 8); "
        f"{len(sl.t_end)} transitions in {secs:.3f} s, sampling phase "
        f"{t_samp:.3f} s: {rate:.3f} samples/s")
    log(f"[nuts-d10] n_leapfrog per transition over sampling: mean "
        f"{lf.mean():.2f}, max {lf.max()}; lockstep leaves {rows.size} "
        f"evaluating {rows.sum()} chain rows ({1e3 * secs / rows.size:.1f} "
        f"ms per leaf over the run); divergence share {div:.4f}, mean accept "
        f"{np.mean(diag['accept_prob']):.3f}")
    log(f"[nuts-d10] step sizes {np.array2string(diag['step_size'], precision=4)}")
    log(f"[nuts-d10] split R-hat {np.array2string(rhat, precision=3)}")
    log(f"[nuts-d10] ESS {np.array2string(ess, precision=1)}")
    log(f"[nuts-d10] |median log10 theta - MAP| "
        f"{np.array2string(med_off, precision=3)} (limit 0.6); K1 "
        f"{counts['K1']} K2 {counts['K2']} launches; peak memory "
        f"{peak:.2f} GiB")
    ok = (finite and div < 0.05 and bool(np.all(med_off < 0.6)) and lp_ok
          and samples.shape == (B, S, info.n_hp))
    if not ok:
        raise SystemExit("[nuts-d10] failed: non-finite samples, divergences "
                         "at 5% or more, a median away from the MAP, or the "
                         "card's log posterior off the CPU path's")

    z_last = hp_to_z(torch.as_tensor(log_s[:, -1], device="cuda"))
    state = _state_at(torch, nuts, lg, z_last, diag, 2)

    def transitions():
        s = state
        for _ in range(2):
            s = nuts.nuts_step(lg, s, NUTS_D10["max_depth"])
    prof = profile_fn(torch, "[nuts-d10] 2 adapted transitions", transitions,
                      GROUPS)
    return dict(ms_per_leapfrog_B8=lf_ms, samples_per_s=rate,
                sampling_s=t_samp, run_s=secs, transitions=len(sl.t_end),
                leaves=int(rows.size), chain_rows=int(rows.sum()),
                mean_n_leapfrog=float(lf.mean()), divergence_share=div,
                mean_accept=float(np.mean(diag["accept_prob"])),
                step_size=diag["step_size"].tolist(), rhat=rhat.tolist(),
                ess=ess.tolist(), median_offset=med_off.tolist(),
                launches=counts, peak_gib=peak,
                logpost_card_vs_cpu_rel=[rel_v, rel_g],
                idle_share=None if prof is None else prof["idle_share"])


def _small_logpost(torch, tgp, rosenbrock):
    """bench.py's NUTS target (bench.py:355-374): Rosenbrock n=32, d=2,
    SqExp precon, f64, calc_etaK, box [-4, 2], on the card."""
    from gpgradpy_torch.inference import nuts
    from gpgradpy_torch.model import conditioning
    n, d = SMALL_N, SMALL_D
    x, f, g, _, _, _ = _rosen_problem(rosenbrock, n, d)
    cfg = tgp.GpConfig(dim=d, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon", dtype="float64",
                       cond_max_target=1e10)
    spec = tgp.make_data_spec(d, True, n, std_fval=np.zeros(n),
                              std_grad=np.zeros((n, d)))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device="cuda")
    data = tgp.GpData(x=t(x), fval=t(f), std_fval=t(np.zeros(n)), grad=t(g),
                      std_grad=t(np.zeros((n, d))))
    info = tgp.HpInfo(dim=d)
    lb, ub = np.full(info.n_hp, -4.0), np.full(info.n_hp, 2.0)
    logpost, z_to_hp, _ = nuts.make_gp_logpost(
        cfg, spec, info, data, conditioning.calc_etaK(cfg, n), lb, ub)
    return logpost, z_to_hp, info.n_hp


def phase_nuts_256(torch, ca, tgp, rosenbrock):
    """[nuts-256]: bench.py's NUTS samples/s configuration (NUTS_256):
    samples/s as bench.py counts it (chains x samples over the whole run)
    and over the sampling phase, then the idle share of one adapted
    transition."""
    from gpgradpy_torch.inference import nuts
    logpost, _, n_hp = _small_logpost(torch, tgp, rosenbrock)
    B, S = NUTS_256["n_chains"], NUTS_256["n_samples"]
    kw = {k: v for k, v in NUTS_256.items() if k != "n_chains"}
    with StepLog(torch, nuts) as sl:
        (zs, diag), secs, counts = _path(
            torch, ca, "[nuts-256] run",
            lambda: nuts.run_nuts(
                logpost, torch.zeros((B, n_hp), dtype=torch.float64,
                                     device="cuda"),
                nuts.Draws(0, "cuda"), **kw))
    rows = np.asarray(sl.rows)
    div = float(diag["diverging"].double().mean())
    rate, rate_s = B * S / secs, B * S / sl.sampling_s(S)
    log(f"[nuts-256] {B} chains x {S} samples (n={SMALL_N}, d={SMALL_D}, "
        f"SqExp precon f64, {json.dumps(kw)}) in {secs:.3f} s: {rate:.1f} "
        f"samples/s ({rate_s:.1f} over the sampling phase); divergence "
        f"share {div:.4f}, mean accept "
        f"{float(diag['accept_prob'].mean()):.3f}, mean n_leapfrog "
        f"{float(diag['n_leapfrog'].double().mean()):.2f}; lockstep leaves "
        f"{rows.size} ({1e3 * secs / rows.size:.2f} ms each, "
        f"{rows.mean():.1f} chains each); K1 {counts['K1']} K2 "
        f"{counts['K2']} launches")
    if not bool(torch.isfinite(zs).all()):
        raise SystemExit("[nuts-256] non-finite samples")
    lg = nuts.value_and_grad(logpost)
    state = _state_at(torch, nuts, lg, zs[:, -1], {
        k: diag[k].cpu().numpy() for k in ("step_size", "inv_mass")}, 3)

    # one transition: ~60 lockstep leaves of ~480 host ops each, whose
    # profiler records take longer to gather than the transition runs
    prof = profile_fn(torch, "[nuts-256] 1 adapted transition",
                      lambda: nuts.nuts_step(lg, state, NUTS_256["max_depth"]),
                      GROUPS)
    return dict(run_s=secs, samples_per_s=rate, samples_per_s_sampling=rate_s,
                divergence_share=div, leaves=int(rows.size),
                launches=counts,
                idle_share=None if prof is None else prof["idle_share"])


def phase_advi_smc(torch, ca, tgp, rosenbrock):
    """[advi] (1000 steps, n_mc 8: K1 forward, K2 backward per step) and
    [smc] (512 particles, 20 stages, 5 moves: value only, K1) with the JAX
    defaults on bench.py's NUTS target; each fails on a non-finite
    result."""
    from gpgradpy_torch.inference import nuts, smc, vi
    logpost, z_to_hp, n_hp = _small_logpost(torch, tgp, rosenbrock)
    f64 = torch.float64
    res, t_vi, c_vi = _path(
        torch, ca, "[advi] 1000 steps, n_mc 8",
        lambda: vi.run_advi(logpost, torch.zeros(n_hp, dtype=f64,
                                                 device="cuda"),
                            nuts.Draws(0, "cuda"), n_steps=1000, n_mc=8))
    elbo = res.elbo_trace
    log(f"[advi] {t_vi:.3f} s ({1e3 * t_vi / 1000:.2f} ms per step): last "
        f"ELBO {float(elbo[-1]):.6g} (first {float(elbo[0]):.6g}), log10 "
        f"theta at mu {z_to_hp(res.mu).cpu().numpy().round(4)}, sigma "
        f"{torch.exp(res.log_sigma).cpu().numpy().round(4)}; K1 {c_vi['K1']} "
        f"K2 {c_vi['K2']} launches")
    if not all(bool(torch.isfinite(t).all()) for t in res):
        raise SystemExit("[advi] non-finite result")

    def prior(draws, n):
        # the box-uniform prior of make_gp_logpost, in z
        u = draws.uniform((n, n_hp), f64)
        return torch.log(u) - torch.log1p(-u)
    r, t_smc, c_smc = _path(
        torch, ca, "[smc] 512 particles, 20 stages, 5 moves",
        lambda: smc.run_smc(logpost, prior, nuts.Draws(0, "cuda"),
                            n_particles=512, n_stages=20, n_mcmc=5),
        need=("K1",))
    w = torch.softmax(r.log_weights, 0)
    mean_hp = (w[:, None] * z_to_hp(r.particles)).sum(0)
    log(f"[smc] {t_smc:.3f} s: min ESS share {float(r.ess_trace.min()):.4f}"
        f", weighted mean log10 theta {mean_hp.cpu().numpy().round(4)}; K1 "
        f"{c_smc['K1']} K2 {c_smc['K2']} launches (value only)")
    if not all(bool(torch.isfinite(t).all()) for t in
               (r.particles, r.log_weights, r.ess_trace)):
        raise SystemExit("[smc] non-finite result")
    return dict(advi=dict(s=t_vi, last_elbo=float(elbo[-1]), launches=c_vi),
                smc=dict(s=t_smc, min_ess=float(r.ess_trace.min()),
                         launches=c_smc))


# ---------------------------------------------------------------------------
# the BO loop: [bo-d10]
# ---------------------------------------------------------------------------

# the paper's d=10 run (examples/run_paper_traces.py:93-96,163-168):
# Rosenbrock a=10 on [-2, 2]^10, SqExp, precon, f64, n_init = d + 2 = 12,
# EI, the local trust-region exploit with a precon local GP, seed 0.  It is
# resumed from the repo's trace of that run after its first 104 evaluations
# (12 initial points + 92 iterations) and runs 6 steps: with n_iter 98 and
# exploit_frac 3.5 / 98 the exploit phase starts at i >= 94.5, so
# iterations 92-94 explore (a global refit at n_eval 104-106, N = 1144-1166
# covariance rows, then propose_next) and 95-97 exploit
BO_TRACE = "results_data/full_d10/Rosen_a10_d10_Precondition_s0.npz"
BO_D10 = dict(n_init=12, n_resume=104, n_iter=98, exploit_frac=3.5 / 98,
              seed=0)
BO_GP = {"device": "cuda"}
# card vs CPU: EI and its gradient to 1e-9 of the largest entry of the
# surrogate terms they are built from (|mu - f*| + sig, |dmu| + |dsig|).
# Not of EI's own largest entry: at EI's stationary point (the proposal)
# its gradient (largest entry 1.5 at this phase's last explore step) is
# ~200x below its terms (dmu up to ~290), and two LAPACK builds set those
# ~1e-10 apart at cond ~1e10 (ROADMAP.md Queue 3); that measure is
# printed too
BO_ACQ_RTOL = 1e-9
BO_PROPOSAL_RTOL = 1e-6  # EI at the card's and the CPU's proposals


class BoStepLog:
    """Inside the block, records each step of bo.loop.run_bo: the global
    refit's and propose_next's wall seconds (after a sync), the acquisition
    L-BFGS's iterations, objective calls and rows per call, the local
    exploit's seconds and its local fit's, and the K1/K2 launches between
    two truth evaluations (the counts are set to 0 at each evaluation, so
    each step's count starts just before it)."""

    def __init__(self, torch, ca, loop, lbfgs, GaussianProcess, obj):
        self.torch, self.ca, self.loop, self.lbfgs = torch, ca, loop, lbfgs
        self.GP, self.obj = GaussianProcess, obj
        self.steps, self.cur = [], {}
        self.proposals = []  # (gp, fbest, seed, acq, x_new) per propose
        self.in_propose = False

    def sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def timed(self, key, fn):
        def run(*a, **kw):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.sync()
            self.cur[key] = self.cur.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    def objective(self, x):
        out = self.obj(x)
        if len(x) == 1:              # a step's truth evaluation
            self.sync()
            self.cur["K1"] = self.ca.kern_grad.launches
            self.cur["K2"] = self.ca.kern_grad_vjp_theta.launches
            self.steps.append(self.cur)
            self.cur = {}
        self.ca.reset_launches()
        return out

    def __enter__(self):
        loop, lbfgs, GP = self.loop, self.lbfgs, self.GP
        self.orig = (loop.propose_next, loop._propose_local_exploit,
                     lbfgs.lbfgs_box_multistart, GP.set_hpara)
        propose, local, solver, set_hpara = self.orig
        log_ = self

        def propose_rec(gp, lb, ub, fbest, seed=0, **kw):
            log_.in_propose = True
            x = log_.timed("propose_s", propose)(gp, lb, ub, fbest,
                                                 seed=seed, **kw)
            log_.in_propose = False
            log_.proposals.append((gp, fbest, seed, kw.get("acq"), x))
            return x

        def solver_rec(fun, x0, *a, **kw):
            if not log_.in_propose:      # a hyperparameter fit's L-BFGS
                return solver(fun, x0, *a, **kw)
            rows = []

            def fun_rec(X):
                rows.append(len(X))
                return fun(X)
            res = solver(fun_rec, x0, *a, **kw)
            log_.cur.update(lbfgs_iters=res.n_iter.tolist(),
                            calls=len(rows), rows=int(sum(rows)))
            return res

        def set_hpara_rec(gp, method, *a, **kw):
            key = "refit_s" if method == "optz" else "set_hpara_s"
            return log_.timed(key, set_hpara)(gp, method, *a, **kw)

        loop.propose_next = propose_rec
        loop._propose_local_exploit = self.timed("exploit_s", local)
        lbfgs.lbfgs_box_multistart = solver_rec
        GP.set_hpara = set_hpara_rec
        return self

    def __exit__(self, *exc):
        loop, lbfgs, GP = self.loop, self.lbfgs, self.GP
        (loop.propose_next, loop._propose_local_exploit,
         lbfgs.lbfgs_box_multistart, GP.set_hpara) = self.orig


def _bo_card_vs_cpu(torch, GaussianProcess, loop, gp, fbest, seed, x_card,
                    lb, ub):
    """The global GP of an explore step on the card against a CPU GP on the
    same data with the card's fitted hyperparameters: the EI objective and
    its gradient at propose_next's 17 starts and at the card's proposal
    (see BO_ACQ_RTOL), then EI at the card's and at
    the CPU's own proposal (rtol BO_PROPOSAL_RTOL).  The x values are not
    compared: a flat EI lets them differ."""
    from gpgradpy_torch import convert
    d = gp.cfg.dim
    cpu = GaussianProcess(d, True, gp.cfg.kernel_type, gp.cfg.wellcond_mtd,
                          device="cpu")
    cpu.init_optz_surr(1)
    cpu.set_data(gp._x_eval_in, gp._fval_in, gp._std_fval_in, gp._grad_in,
                 gp._std_grad_in)
    cpu.set_custom_hp(**convert.hypers_to_numpy(gp.hp_vals))
    cpu.set_hpara("current", 0)
    X = np.vstack([loop.acq_starts(gp, lb, ub, 16, seed), x_card[None, :]])
    a_c, g_c, _ = loop.acq_objective(gp, "ei", 2.0, fbest)(X)
    a_h, g_h, _ = loop.acq_objective(cpu, "ei", 2.0, fbest)(X)
    mu, sig, dmu, dsig = cpu.eval_model(X, calc_grad=True)[:4]
    scale_a = np.max(np.abs(mu - fbest) + sig)
    scale_g = np.max(np.abs(dmu) + np.abs(dsig))
    err_a = float(np.max(np.abs(a_c - a_h)) / scale_a)
    err_g = float(np.max(np.abs(g_c - g_h)) / scale_g)
    own_a = float(np.max(np.abs(a_c - a_h)) / np.max(np.abs(a_h)))
    own_g = float(np.max(np.abs(g_c - g_h)) / np.max(np.abs(g_h)))
    row_err = np.max(np.abs(g_c - g_h), 1) / scale_g
    t0 = time.perf_counter()
    x_cpu = loop.propose_next(cpu, lb, ub, fbest, acq="ei", seed=seed)
    t_cpu = time.perf_counter() - t0
    ei_card = float(a_c[-1])
    ei_cpu = float(loop.acq_objective(cpu, "ei", 2.0, fbest)(
        x_cpu[None, :])[0][0])
    err_p = abs(ei_card - ei_cpu) / abs(ei_cpu)
    ok = err_a <= BO_ACQ_RTOL and err_g <= BO_ACQ_RTOL \
        and err_p <= BO_PROPOSAL_RTOL
    log(f"[bo-d10] card vs CPU at the last explore step's GP (N = "
        f"{gp.spec.n_data}): -EI at the 17 starts and the proposal, max "
        f"|diff| / max (|mu - f*| + sig) {err_a:.3e} ({scale_a:.4g}), "
        f"gradient / max (|dmu| + |dsig|) {err_g:.3e} ({scale_g:.4g}) (tol "
        f"{BO_ACQ_RTOL:.0e}; per row {np.array2string(row_err, precision=1)}"
        f"); of EI's own largest entry {own_a:.3e} / {own_g:.3e}; -EI at "
        f"the card's proposal {ei_card:.10g}, at the CPU's "
        f"{ei_cpu:.10g}: rel {err_p:.3e} (tol {BO_PROPOSAL_RTOL:.0e}); "
        f"|x_card - x_cpu| {np.max(np.abs(x_card - x_cpu)):.3e}; the CPU's "
        f"propose_next took {t_cpu:.2f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("[bo-d10] the card's acquisition disagrees with the "
                         "CPU path")
    return dict(ei_rel=err_a, grad_rel=err_g, ei_rel_own=own_a,
                grad_rel_own=own_g, proposal_ei_rel=err_p, cpu_propose_s=t_cpu)


def phase_bo_d10(torch, ca, GaussianProcess, rosenbrock):
    """[bo-d10]: run_bo resumed from the d=10 trace for 6 steps (BO_D10):
    each step's seconds, L-BFGS work and launches; every explore step's
    refit must launch K1 and K2, every exploit step's local fit K1; every
    merit and optimality finite, every proposal in the box; the split of
    3 explore and 3 exploit steps read from run_bo's verbose record; the
    card's acquisition against the CPU path; one propose_next profiled."""
    import contextlib
    import io
    from gpgradpy_torch.bo import loop
    from gpgradpy_torch.fit import lbfgs
    cfg = BO_D10
    d, n0, n_res = 10, cfg["n_init"], cfg["n_resume"]
    lb, ub = np.full(d, -2.0), np.full(d, 2.0)
    rec = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               BO_TRACE))
    n_total = n0 + cfg["n_iter"]

    def head(a):
        out = np.full((n_total,) + a.shape[1:], np.nan)
        out[:n_res] = a[:n_res]
        return out
    resume = loop.BoTrace(**{k: head(rec[k]) for k in loop.BoTrace._fields})
    n_steps = cfg["n_iter"] - (n_res - n0)
    buf = io.StringIO()
    torch.cuda.synchronize()
    ca.reset_launches()
    t0 = time.perf_counter()
    with BoStepLog(torch, ca, loop, lbfgs, GaussianProcess,
                   rosenbrock) as bl, contextlib.redirect_stdout(buf):
        trace = loop.run_bo(bl.objective, lb, ub, cfg["n_iter"], n_init=n0,
                            kernel_type="SqExp", wellcond_mtd="precon",
                            acq="ei", exploit_frac=cfg["exploit_frac"],
                            exploit_local=True, exploit_wellcond="precon",
                            seed=cfg["seed"], gp_options=BO_GP, verbose=True,
                            resume_trace=resume)
    run_s = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[bo-d10] run_bo: {line}")
    kinds = ["exploit" if "exploit[" in s else "explore" for s in lines]
    steps = bl.steps
    new = slice(n_res, n_total)
    bad = []
    if kinds != ["explore"] * 3 + ["exploit"] * 3 or len(steps) != n_steps:
        bad.append(f"steps {kinds} ({len(steps)} evaluated), not 3 explore "
                   "then 3 exploit")
    for i, (kind, st) in enumerate(zip(kinds, steps)):
        k = n_res + i
        t_it = float(trace.time_iter[k])
        it = np.asarray(st.get("lbfgs_iters", [0]))
        calls = st.get("calls", 0)
        # in an exploit step the refit is the local GP's fit
        fit = "refit" if kind == "explore" else "local fit"
        log(f"[bo-d10] step {i} (iteration {k - n0}, {kind}, n_eval {k}): "
            f"time_iter {t_it:.3f} s; {fit} {st.get('refit_s', 0.0):.3f} s, "
            f"propose {st.get('propose_s', 0.0):.3f} s, local exploit "
            f"{st.get('exploit_s', 0.0):.3f} s; acquisition L-BFGS "
            f"iterations mean {it.mean():.1f} max {it.max()}, {calls} "
            f"objective calls, {st.get('rows', 0) / max(calls, 1):.1f} points"
            f" per call; launches K1 {st['K1']} K2 {st['K2']}; merit "
            f"{trace.merit_all[k]:.4e}")
        need = ("K1", "K2") if kind == "explore" else ("K1",)
        if min(st[c] for c in need) < 1:
            bad.append(f"step {i} ({kind}) launched no {need}")
    x_new = trace.x_all[new]
    finite = bool(np.all(np.isfinite(trace.merit_all[new]))
                  and np.all(np.isfinite(trace.opt_all[new])))
    in_box = bool(np.all((x_new >= lb) & (x_new <= ub)))
    if not (finite and in_box):
        bad.append(f"finite {finite}, in the box {in_box}")
    if bad:
        raise SystemExit(f"[bo-d10] failed: {bad}")

    gp, fbest, seed, _, x_card = [p for p in bl.proposals
                                  if p[3] == "ei"][-1]
    cvc = _bo_card_vs_cpu(torch, GaussianProcess, loop, gp, fbest, seed,
                          x_card, lb, ub)
    prof = profile_fn(torch, "[bo-d10] one propose_next (EI, 17 starts)",
                      lambda: loop.propose_next(gp, lb, ub, fbest, acq="ei",
                                                seed=seed), GROUPS)
    explore = [float(trace.time_iter[n_res + i]) for i, k in enumerate(kinds)
               if k == "explore"]
    exploit = [float(trace.time_iter[n_res + i]) for i, k in enumerate(kinds)
               if k == "exploit"]
    log(f"[bo-d10] seconds per step: explore {', '.join(f'{t:.3f}' for t in explore)}"
        f"; exploit {', '.join(f'{t:.3f}' for t in exploit)}; run "
        f"{run_s:.2f} s (the replay included)")
    return dict(explore_s=explore, exploit_s=exploit, run_s=run_s,
                steps=steps, card_vs_cpu=cvc,
                propose_profile=None if prof is None else {
                    k: prof[k] for k in ("device_ms", "wall_ms",
                                         "idle_share")})


POLISH_CFGS = (  # label, facade options, d at which the polished -ln L is
    # held to the f64 fit's.  The TPU recipe's 10 polish iterations stop
    # 3.3e-4 above the f64 optimum at d=10: the L-BFGS needs 19 there, in
    # both packages (CPU, from one start: JAX 6310.233929951, port
    # 6310.233929960; 20 iterations reach 6308.118320 against the f64
    # fit's 6308.118244).  So at d=10 the JAX package's default of 20 is
    # held and the 10-iteration gap is printed (PERF.md section 6).
    ("f64 at 1e10", dict(dtype="float64", cond_max_target=1e10), ()),
    ("f32 at 1e6", dict(dtype="float32", cond_max_target=1e6), ()),
    ("f32 at 1e6 + polish at 1e10",
     dict(dtype="float32", cond_max_target=1e6, polish_cond_target=1e10,
          polish_iter_max=10), (4,)),
    ("f32 at 1e6 + polish at 1e10, 20 iterations",
     dict(dtype="float32", cond_max_target=1e6, polish_cond_target=1e10,
          polish_iter_max=20), (4, 10)),
)
POLISH_LNL_RTOL = 1e-6   # tests/test_torch_polish.py, the facade criterion
REFINE_TOL = 1e-6        # tests/test_torch_polish.py (JAX tests/test_refine.py)


def _count_polish(ca, gp, out):
    """Wrap gp._polish_fit so that the launches it makes land in ``out``."""
    inner = gp._polish_fit

    def counted(fit, i_optz):
        c0 = _counts(ca)
        res = inner(fit, i_optz)
        for k, v in _counts(ca).items():
            out[k] += v - c0[k]
        return res
    gp._polish_fit = counted


def _chol_ms(torch, n, dtype, reps=20):
    """ms of one Cholesky of an n x n SPD matrix (CUDA events, warm)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn(n, n, generator=g, device="cuda", dtype=torch.float64)
    A = (A @ A.T / n + torch.eye(n, device="cuda", dtype=torch.float64)
         ).to(dtype)
    torch.linalg.cholesky_ex(A)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        torch.linalg.cholesky_ex(A)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def phase_polish(torch, ca, GaussianProcess, rosenbrock, smi):
    """'[polish]': the three precision recipes on the bench problem (d=4,
    n_eval=64) and at d=10, n_eval=200: warm fit wall (median of 3), -ln L
    of each optimum under one f64 function at 1e10, held-out RMSE, K1/K2
    launches (the polish's f64 launches apart); the f32 and f64 Cholesky
    at N=2200; a refined predict against the f64 predict."""
    from gpgradpy_torch.fit import multistart
    out = {"card": smi}
    for d, n in ((4, 64), (10, 200)):
        x, f, g, xt, ft, _ = _rosen_problem(rosenbrock, n, d)
        rows = {}
        for label, kw, _ in POLISH_CFGS:
            walls, polish_counts = [], {"K1": 0, "K2": 0}
            for rep in range(4):     # the first pays its precision's start-up
                def fit():
                    gp = GaussianProcess(d, True, "SqExp", "precon",
                                         device="cuda", **kw)
                    gp.init_optz_surr(2)
                    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
                    if rep == 3:
                        _count_polish(ca, gp, polish_counts)
                    gp.set_hpara("optz", 0)
                    return gp
                gp, secs, counts = _path(
                    torch, ca, f"[polish] d={d} {label} fit {rep}", fit)
                walls += [secs] if rep else []
            mu = gp.eval_model(xt)[0]
            rows[label] = dict(
                gp=gp, wall_s=float(np.median(walls)), walls_s=walls,
                rmse=float(np.sqrt(np.mean((mu - ft) ** 2))),
                launches=counts, polish_launches=polish_counts,
                lnL_own=float(gp.history.ln_lkd[0]),
                iters=[i["hp_optz_iter_max"] for i in gp.optz_infos])
        # -ln L of each optimum under one f64 function at cond 1e10 (the
        # f64 facade's): the three optima on one scale
        g64 = rows["f64 at 1e10"]["gp"]
        X = np.log10(np.stack([r["gp"].history.hp_theta[0]
                               for r in rows.values()]))
        ref, _ = multistart.scan_neg_mll(g64.cfg, g64.spec,
                                         g64.hp_info_optz_lkd, g64.data,
                                         float(g64._etaK), X)
        gate = 0.01 * float(np.std(ft))
        res = {}
        for (label, r), v in zip(rows.items(), ref):
            r.pop("gp")
            r["neg_lnL_f64"] = float(v)
            res[label] = r
            log(f"[polish] {smi} | d={d} n_eval={n} {label}: warm fit "
                f"{r['wall_s']:.3f} s (median of {r['walls_s']}), -lnL at "
                f"f64/1e10 {v:.10g} (own {-r['lnL_own']:.10g}), held-out "
                f"rmse {r['rmse']:.6g}"
                + (f" (gate {gate:.6g})" if d == 4 else "")
                + f", L-BFGS iterations {r['iters']}, launches K1 "
                f"{r['launches']['K1']} K2 {r['launches']['K2']}, of them "
                f"the polish's f64 K1 {r['polish_launches']['K1']} K2 "
                f"{r['polish_launches']['K2']}")
        f64 = res["f64 at 1e10"]
        for label, _, held_at in POLISH_CFGS[2:]:
            pol = res[label]
            dl = abs(pol["neg_lnL_f64"] - f64["neg_lnL_f64"]) / abs(
                f64["neg_lnL_f64"])
            pol["rel_neg_lnL_vs_f64"] = dl
            held = d in held_at
            log(f"[polish] d={d} {label}: polished -lnL vs the f64 fit's: "
                f"rel {dl:.3e} (tol {POLISH_LNL_RTOL:.0e}"
                f"{'' if held else ', not held here: printed'}); wall / "
                f"f64's {pol['wall_s'] / f64['wall_s']:.3f}")
            if held and not dl < POLISH_LNL_RTOL:
                raise SystemExit(f"[polish] d={d} {label}: the polished "
                                 "-lnL misses the f64 fit's")
            if min(pol["polish_launches"].values()) < 1:
                raise SystemExit(f"[polish] d={d}: K1/K2 did not launch in "
                                 "the f64 polish")
            if min(pol["launches"][k] - pol["polish_launches"][k]
                   for k in ("K1", "K2")) < 1:
                raise SystemExit(f"[polish] d={d}: K1/K2 did not launch in "
                                 "the f32 fit")
            if d == 4 and not pol["rmse"] < gate:
                raise SystemExit(f"[polish] d=4 {label}: RMSE gate failed")
        if d == 4 and not f64["rmse"] < gate:
            raise SystemExit("[polish] d=4: the f64 fit's RMSE gate failed")
        out[f"d{d}"] = res

    # a refined predict: f32 fit + n_refine_predict=2 against the f64
    # predict at the same hyperparameters, on f32-representable data
    d, n = 10, 200
    x, f, g, xt, _, _ = _rosen_problem(rosenbrock, n, d)
    x, f, g, xt = (np.float32(a).astype(np.float64) for a in (x, f, g, xt))

    def model(**kw):
        gp = GaussianProcess(d, True, "SqExp", "precon", device="cuda",
                             cond_max_target=1e6, **kw)
        gp.init_optz_surr(2)
        gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
        return gp

    def refined():
        gp = model(dtype="float32", n_refine_predict=2)
        gp.set_hpara("optz", 0)
        return gp, gp.eval_model(xt, calc_grad=True)[:4]
    (gp_r, pred_r), t_r, c_r = _path(
        torch, ca, "[polish] d=10 f32 fit + refined predict", refined)
    hp = gp_r.hp_vals
    gp_64 = model(dtype="float64")
    gp_64.set_custom_hp(beta=hp.beta.double().cpu().numpy(),
                        theta=hp.theta.double().cpu().numpy(),
                        varK=float(hp.varK))
    gp_64.set_hpara("current", 0)
    pred_64 = gp_64.eval_model(xt, calc_grad=True)[:4]
    errs = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
            for a, b in zip(pred_r, pred_64)]
    log(f"[polish] d=10 refined predict (f32 factor, 2 refinements) vs f64 "
        f"at the same hyperparameters, rel err mu/sig/dmu/dsig "
        f"{['%.3e' % e for e in errs]} (tol {REFINE_TOL:.0e}); dtype "
        f"{pred_r[0].dtype}")
    if not (max(errs) < REFINE_TOL and pred_r[0].dtype == np.float64):
        raise SystemExit("[polish] the refined predict misses the f64 one")
    out["refined_predict_rel_err"] = errs

    out["cholesky_ms_n2200"] = {dt: _chol_ms(torch, 2200, getattr(torch, dt))
                                for dt in ("float32", "float64")}
    c = out["cholesky_ms_n2200"]
    log(f"[polish] {smi} | Cholesky N=2200: f32 {c['float32']:.4f} ms, "
        f"f64 {c['float64']:.4f} ms, ratio f64/f32 "
        f"{c['float64'] / c['float32']:.3f}")
    return out


# a row of the batched grid against one evaluation: cuSOLVER's batched and
# single-matrix Cholesky take different code paths, which at cond 3.9e9
# set -ln L 3.8e-10 apart on an H100 (PERF.md section 6); the limit is
# about 10x that reading.  The grid row against the CPU port read 8.7e-13
# at cond 3.8e9.
UTILS_GRID_RTOL = {False: 1e-10, True: 5e-9}   # keyed by cond >= 1e8
UTILS_CPU_RTOL = 1e-9


def phase_utils(torch, ca, GaussianProcess, rosenbrock, smi):
    """'[utils]': lkd_grid at d=10, n_eval=200, n_grid 10 (one K1 launch at
    B=100), three grid points against single card evaluations and one
    against the CPU port; get_txt_info_surr."""
    from gpgradpy_torch.utils import lkd_contour
    d, n = 10, 200
    x, f, g, _, _, _ = _rosen_problem(rosenbrock, n, d)
    gp = _fit(GaussianProcess, x, f, g)
    torch.cuda.reset_peak_memory_stats()
    (vi, vj, val), secs, counts = _path(
        torch, ca, "[utils] lkd_grid d=10 n_grid 10",
        lambda: lkd_contour.lkd_grid(gp, (0, 1), 10), need=("K1",))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[utils] {smi} | lkd_grid d=10 n_eval=200 n_grid 10: {secs:.3f} s, "
        f"K1 {counts['K1']}, finite {int(np.isfinite(val).sum())}/100, "
        f"range {np.nanmin(val):.6g} .. {np.nanmax(val[np.isfinite(val)]):.6g}"
        f", peak memory {peak:.2f} GiB")
    theta = gp.hp_vals.theta.cpu().numpy()
    worst = 0.0
    for k, (i, j) in enumerate(((2, 3), (5, 5), (8, 1))):
        th = theta.copy()
        th[0], th[1] = 10.0 ** vi[i], 10.0 ** vj[j]
        lkd, _ = gp.calc_lkd_all(gp.make_hp_class(theta=th), calc_cond=True)
        one, cond = -float(lkd.ln_lkd), float(lkd.cond)
        rel = abs(val[j, i] - one) / abs(one)
        tol = UTILS_GRID_RTOL[cond >= 1e8]
        worst = max(worst, rel / tol)
        log(f"[utils] grid ({i}, {j}), cond {cond:.3e}: {val[j, i]:.12g} vs "
            f"one card evaluation {one:.12g}, rel {rel:.3e} (tol {tol:.0e})")
        if k == 1:
            cpu = GaussianProcess(d, True, "SqExp", "precon", device="cpu")
            cpu.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
            lkd_c, _ = cpu.calc_lkd_all(cpu.make_hp_class(theta=th))
            rel_c = abs(val[j, i] + float(lkd_c.ln_lkd)) / abs(one)
            log(f"[utils] grid ({i}, {j}) vs the CPU port: rel {rel_c:.3e} "
                f"(tol {UTILS_CPU_RTOL:.0e})")
    if not (worst < 1.0 and rel_c < UTILS_CPU_RTOL):
        raise SystemExit("[utils] lkd_grid disagrees with single evaluations")
    text = gp.get_txt_info_surr()
    log(f"[utils] get_txt_info_surr ({len(text.splitlines())} lines):")
    for line in text.splitlines():
        log(f"[utils] | {line}")
    if not text.strip() or "Optimization stats:" not in text:
        raise SystemExit("[utils] get_txt_info_surr is empty")
    return {"lkd_grid_s": secs, "lkd_grid_launches": counts,
            "grid_vs_single_err_over_tol": worst, "grid_vs_cpu_rel": rel_c}


def phase_examples(torch, ca, smi):
    """'[examples]': the compute parts of plt_cond, plt_nugget_1d,
    plt_kern_corr and plt_surr_1d on the card against the CPU, and one
    run_paper_traces worker (Precondition, start 0, d=5, 8 iterations)
    loaded back through PltOptzResults."""
    import shutil
    from gpgradpy_torch.examples import (plt_cond, plt_kern_corr,
                                         plt_nugget_1d, plt_surr_1d,
                                         run_paper_traces)
    from gpgradpy_torch.results import PltOptzResults

    def close(a, b, rtol, atol=0.0):
        a, b = np.asarray(a), np.asarray(b)
        if not (rtol or atol):
            return np.array_equal(a, b), 0.0
        same_nan = np.array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(b)
        err = float(np.max(np.abs(a[m] - b[m]) / (atol + rtol * np.abs(b[m]))))
        return same_nan and err <= 1.0, err

    out, bad = {}, []
    cases = (
        ("plt_cond", lambda dev: plt_cond.compute(device=dev),
         lambda r: [m for maps in r[1].values() for m in maps],
         (("log10 cond", 0.0, 1e-5), ("ln lkd", 1e-7, 0.0)) * 2),
        ("plt_nugget_1d", lambda dev: plt_nugget_1d.compute(device=dev),
         lambda r: [np.log10(c) for c in r[1].values()],
         (("log10 cond", 0.0, 1e-5),) * 3),
        ("plt_kern_corr", lambda dev: plt_kern_corr.compute(device=dev),
         lambda r: [v for c in r[1].values() for v in c],
         (("k, k', k''", 1e-12, 1e-14),) * 9),
        ("plt_surr_1d", lambda dev: plt_surr_1d.compute(device=dev),
         lambda r: [r["lkd_vals"], r["idx_max"], r["mu"], r["sig"]],
         (("lkd", 1e-7, 0.0), ("maxima", 0.0, 0.0), ("mu", 0.0, 1e-4),
          ("sig", 0.0, 1e-4))),
    )
    for name, run, parts, tols in cases:
        # plt_kern_corr differentiates the scalar kernel: no K1 there
        need = () if name == "plt_kern_corr" else ("K1",)
        card, secs, counts = _path(torch, ca, f"[examples] {name}",
                                   lambda: run("cuda"), need=need)
        cpu = run("cpu")
        errs = []
        for (what, rtol, atol), a, b in zip(tols, parts(card), parts(cpu)):
            if what in ("mu", "sig"):
                atol = atol * float(np.max(np.abs(b)))
            ok, e = close(a, b, rtol, atol)
            errs.append(e)
            bad += [] if ok else [f"{name} {what}"]
        log(f"[examples] {smi} | {name} on the card: {secs:.3f} s, K1 "
            f"{counts['K1']}; card vs CPU, worst error / tolerance "
            f"{max(errs):.3e}")
        out[name] = {"s": secs, "launches": counts, "err_over_tol": max(errs)}
    if bad:
        raise SystemExit(f"[examples] card disagrees with the CPU: {bad}")

    out_dir = os.path.join("build", "chip_smoke_traces")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    n_iter = 8
    trace, secs, counts = _path(
        torch, ca, "[examples] run_paper_traces worker Precondition s0 d=5",
        lambda: run_paper_traces.run_one(5, "Precondition", 0, n_iter,
                                         out_dir, device="cuda"))
    run_paper_traces.merge(5, out_dir, 1, ["Precondition"])
    merit, opt, _ = PltOptzResults.load_npz_data(
        out_dir, ["Rosen_a10_d5_Precondition_all.npz"], n_iter_max=None)
    t_it = np.asarray(trace.time_iter)[-n_iter:]
    log(f"[examples] {smi} | run_paper_traces worker d=5, {n_iter} "
        f"iterations: {secs:.3f} s, s per iteration "
        f"{np.array2string(t_it, precision=3)}; K1 {counts['K1']} K2 "
        f"{counts['K2']}; PltOptzResults merit {merit.shape}, best "
        f"{np.nanmin(merit):.3e}, best ||grad|| {np.nanmin(opt):.3e}")
    if not (merit.shape == (1, 1, 5 + 2 + n_iter)
            and np.all(np.isfinite(merit))):
        raise SystemExit("[examples] the worker's trace did not load back")
    out["run_paper_traces"] = {"s": secs, "s_per_iter": t_it.tolist(),
                               "launches": counts,
                               "best_merit": float(np.nanmin(merit))}
    return out


# ---------------------------------------------------------------------------
# [dist]: the multi-device paths on a world-size-1 NCCL group
# ---------------------------------------------------------------------------

# the theta of the BO-size iterative fit (tests/test_torch_iterative.py's
# D10_THETA): [dist] runs alone too, without the [iterative] phase's fit
DIST_THETA = [0.027093557373919882, 0.027530130887621563, 0.02778187069296766,
              0.030307737839111188, 0.028773219110307478, 0.027960749037072498,
              0.027408229519886425, 0.02816712579461613, 0.029777609591534502,
              0.001065027274516044]
# the sharded matvec against KernMatvecFn: the same K1 tiles and products
# on a permuted vector, so a few ulp of max|out| (forward and K2's theta)
DIST_MATVEC_RTOL = 1e-13
# one objective and the predict with the mesh against the mesh-free ones on
# the same (permuted) probes: CG converged in both (cond_max_target 1e4,
# the cap above the iterations it needs), so only the order of the sums
# differs.  The objective's value and gradient are held to 1e-10 (read
# 8.7e-13 / 1.4e-12 on an H100); the predict's mu and sig, two converged
# solves of the same system (residual < 1e-10 each, so apart by up to
# ~cond x 1e-10), to 1e-8 and 1e-7 (read 2.5e-10 / 6.0e-9: sig subtracts
# K_yx^T K^-1 K_yx from 1 and loses digits where it is small)
DIST_ITER_COND = dict(cond_max_target=1e4, cond_max=1e4, iter_max_cg=4096)
DIST_ITER_RTOL = 1e-10
DIST_PRED_RTOL = {"mu": 1e-8, "sig": 1e-7}
# cholesky_dist against torch.linalg.cholesky: factor / max|L|, logdet
CHOL_DIST_TOL, CHOL_DIST_LOGDET_RTOL = 1e-9, 1e-10
# solver="dense_dist" against the dense fit on the same data
DD_LNL_RTOL, DD_MU_RTOL = 1e-6, 1e-6
# sample_posterior(use_mesh=True) against run_nuts with pooled adaptation,
# cut from the facade's 400 + 400 transitions at depth 8 to keep [dist]
# near 150 s: a leapfrog of 8 chains at d=10 takes ~80 ms (PERF.md)
DIST_NUTS = dict(n_warmup=5, n_samples=5, max_depth=4)
DIST_NUTS_TOL = 1e-12


class Collectives:
    """Counts the torch.distributed all_gather / all_reduce calls made
    inside the block."""

    def __init__(self, dist):
        self.dist, self.counts = dist, {"all_gather": 0, "all_reduce": 0}

    def __enter__(self):
        self.orig = {k: getattr(self.dist, k) for k in self.counts}
        for k, fn in self.orig.items():
            def counted(*a, _k=k, _fn=fn, **kw):
                self.counts[_k] += 1
                return _fn(*a, **kw)
            setattr(self.dist, k, counted)
        return self

    def __exit__(self, *exc):
        for k, fn in self.orig.items():
            setattr(self.dist, k, fn)


def _rel(a, b):
    """max |a - b| / max |b|."""
    a = a.detach().double().cpu().numpy() if hasattr(a, "detach") else a
    b = b.detach().double().cpu().numpy() if hasattr(b, "detach") else b
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _event_ms(torch, fn, reps):
    """Mean device time of fn over reps calls (CUDA events), after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def phase_dist(torch, ca, GaussianProcess, rosenbrock, smi):
    """'[dist]': the multi-device layer on a world-size-1 NCCL group (a
    file:// store under build/): the sharded matvec, one iterative
    objective and predict with iter_use_mesh, cholesky_dist, the
    dense_dist facade fit, sample_posterior(use_mesh=True) and the compute
    parts of large_n_demo and scaling_harness.  Each path counts its K1/K2
    launches from 0 and fails unless the ones it needs launched; every
    check fails the run."""
    import torch.distributed as dist
    from gpgradpy_torch.examples import large_n_demo, scaling_harness
    from gpgradpy_torch.fit.iterative_driver import iter_kw
    from gpgradpy_torch.inference import nuts
    from gpgradpy_torch.inference.draws import Draws
    from gpgradpy_torch.model import likelihood_iter as tli
    from gpgradpy_torch.model import predict_iter as tpi
    from gpgradpy_torch.ops import iterative as it
    from gpgradpy_torch.parallel import chol_dist
    from gpgradpy_torch.parallel import mesh as pmesh
    from gpgradpy_torch.parallel import sharded_matvec as sm
    out, bad = {}, []
    store = os.path.abspath(os.path.join(
        "build", f"chip_smoke_store_{os.getpid()}"))
    os.makedirs("build", exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    pmesh.distributed_initialize("cuda", init_method=f"file://{store}",
                                 rank=0, world_size=1)
    try:
        mesh = pmesh.make_mesh(device="cuda")
        log(f"[dist] {smi} | backend {mesh.backend}, world size {mesh.size}, "
            f"device {mesh.device}")
        if mesh.backend != "nccl":
            raise SystemExit(f"[dist] the group runs {mesh.backend}, not nccl")
        out["backend"] = mesh.backend

        # -- the sharded matvec at [iterative-large]'s size ----------------
        d, n = 10, 2000
        N = n * (d + 1)
        x, f, g, xt, _, _ = _rosen_problem(rosenbrock, n, d, seed=2)
        rng = np.random.default_rng(5)

        def t(a):
            return torch.as_tensor(np.array(a), dtype=torch.float64,
                                   device="cuda")
        xc, th = t(x), t(DIST_THETA)
        Vb, Gb = t(rng.standard_normal((N, 34))), t(rng.standard_normal((N, 34)))
        Vp, Gp = sm.blocked_to_pm_mat(Vb, n, d), sm.blocked_to_pm_mat(Gb, n, d)

        def grads():
            th1 = th.clone().requires_grad_(True)
            th2 = th.clone().requires_grad_(True)
            ref = it.KernMatvecFn.apply("SqExp", 256, xc, th1, None, Vb)
            g1, = torch.autograd.grad((Gb * ref).sum(), th1)
            with Collectives(dist) as coll:
                shd = sm.kern_matvec_sharded_batch(
                    "SqExp", mesh, xc, th2, None, Vp, row_block=256)
                g2, = torch.autograd.grad((Gp * shd).sum(), th2)
            return ref, shd, g1, g2, coll.counts
        (ref, shd, g1, g2, coll), secs, counts = _path(
            torch, ca, "[dist] sharded matvec + theta gradient (and the "
            "unsharded one)", grads)
        fwd = _rel(sm.blocked_to_pm_mat(ref, n, d), shd)
        grd = _rel(g2, g1)
        with torch.no_grad():
            ms_ref = _event_ms(torch, lambda: it.kern_matvec(
                "SqExp", xc, th, None, Vb, row_block=256), 5)
            with Collectives(dist) as coll_f:
                sm.kern_matvec_sharded_batch("SqExp", mesh, xc, th, None, Vp,
                                             row_block=256)
            ms_shd = _event_ms(torch, lambda: sm.kern_matvec_sharded_batch(
                "SqExp", mesh, xc, th, None, Vp, row_block=256), 5)
        ok = fwd <= DIST_MATVEC_RTOL and grd <= DIST_MATVEC_RTOL
        bad += [] if ok else ["sharded matvec"]
        log(f"[dist] {smi} | sharded matvec N={N} x 34 columns: forward rel "
            f"{fwd:.3e}, theta gradient rel {grd:.3e} (limit "
            f"{DIST_MATVEC_RTOL:.0e}) {'ok' if ok else 'FAIL'}; ms per matvec "
            f"sharded {ms_shd:.3f} / unsharded {ms_ref:.3f}; collectives per "
            f"matvec {coll_f.counts}, per forward + backward {coll}")
        out["matvec"] = dict(fwd_rel=fwd, grad_rel=grd, ms=ms_shd,
                             unsharded_ms=ms_ref, launches=counts,
                             collectives_forward=coll_f.counts,
                             collectives_forward_backward=coll)
        del ref, shd, Vb, Gb, Vp, Gp
        torch.cuda.empty_cache()

        # -- one iterative objective and the predict with the mesh ---------
        def make(mesh_on):
            gp = GaussianProcess(d, True, "SqExp", "precon", solver="iterative",
                                 iter_use_mesh=mesh_on, **DIST_ITER_COND)
            gp.set_data(x, f, np.zeros(n), g, np.zeros((n, d)))
            return gp
        gp0, gp1 = make(False), make(True)
        cfg = gp0.cfg
        z = it.rademacher(N, cfg.iter_n_probes, 1, torch.float64, "cuda")
        hp = gp0.make_hp_class(theta=DIST_THETA)
        eta = float(gp0._etaK)
        res0, secs0, c0 = _path(
            torch, ca, "[dist] one iterative objective, no mesh",
            lambda: tli.neg_mll_iterative_and_grad(
                cfg, gp0.spec, gp0.data, hp, eta, z, **iter_kw(cfg)))
        with Collectives(dist) as coll_o:
            res1, secs1, c1 = _path(
                torch, ca, "[dist] one iterative objective, iter_use_mesh",
                lambda: tli.neg_mll_iterative_and_grad(
                    cfg, gp1.spec, gp1.data, hp, eta,
                    sm.blocked_to_pm_mat(z, n, d), mesh=mesh, **iter_kw(cfg)))
        v_rel = _rel(res1[0], res0[0])
        g_rel = _rel(res1[1], res0[1])
        ok = v_rel <= DIST_ITER_RTOL and g_rel <= DIST_ITER_RTOL
        bad += [] if ok else ["iterative objective"]
        log(f"[dist] {smi} | one objective N={N}: -lnL {float(res1[0]):.12g} "
            f"rel {v_rel:.3e}, gradient rel {g_rel:.3e} (limit "
            f"{DIST_ITER_RTOL:.0e}), CG {int(res1[2].cg_iters)} / "
            f"{int(res0[2].cg_iters)} iterations (mesh / none), resid "
            f"{float(res1[2].cg_resid):.2e}; {secs1:.3f} s with the mesh, "
            f"{secs0:.3f} s without; collectives {coll_o.counts} "
            f"{'ok' if ok else 'FAIL'}")
        out["objective"] = dict(val_rel=v_rel, grad_rel=g_rel, s=secs1,
                                s_no_mesh=secs0, launches=c1,
                                cg_iters=int(res1[2].cg_iters),
                                collectives=coll_o.counts)
        xq = t(xt)
        pred0, _, _ = _path(
            torch, ca, "[dist] predict_iterative 128 points, no mesh",
            lambda: tpi.predict_iterative(cfg, gp0.spec, gp0.data, hp, eta,
                                          xq, **iter_kw(cfg)),
            need=("K1",))
        pred1, secs_p, c_p = _path(
            torch, ca, "[dist] predict_iterative 128 points, iter_use_mesh",
            lambda: tpi.predict_iterative(cfg, gp1.spec, gp1.data, hp, eta,
                                          xq, mesh=mesh, **iter_kw(cfg)),
            need=("K1",))
        mu_rel, sig_rel = _rel(pred1[0], pred0[0]), _rel(pred1[1], pred0[1])
        ok = (mu_rel <= DIST_PRED_RTOL["mu"]
              and sig_rel <= DIST_PRED_RTOL["sig"]
              and float(pred1[4].residnorm.max()) < cfg.iter_cg_tol)
        bad += [] if ok else ["iterative predict"]
        log(f"[dist] {smi} | predict_iterative with the mesh: mu rel "
            f"{mu_rel:.3e}, sig rel {sig_rel:.3e} (limits "
            f"{DIST_PRED_RTOL}), CG {int(pred1[4].n_iter)} iterations, "
            f"resid {float(pred1[4].residnorm.max()):.2e}, {secs_p:.3f} s "
            f"{'ok' if ok else 'FAIL'}")
        out["predict"] = dict(mu_rel=mu_rel, sig_rel=sig_rel, s=secs_p,
                              launches=c_p)
        del gp0, gp1, z, pred0, pred1, res0, res1
        torch.cuda.empty_cache()

        # -- cholesky_dist at N = 4096 -------------------------------------
        Nc, blk = 4096, 64
        B = torch.randn(Nc, Nc, dtype=torch.float64, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        A = B @ B.T / Nc + torch.eye(Nc, dtype=torch.float64, device="cuda")
        del B
        L_loc, logdet = chol_dist.cholesky_dist(mesh, A, blk)
        L_ref = torch.linalg.cholesky(A)
        l_err = _rel(L_loc, L_ref)
        ld_ref = 2.0 * torch.log(torch.diagonal(L_ref)).sum()
        ld_err = abs(float(logdet) - float(ld_ref)) / abs(float(ld_ref))
        ms_dist = _event_ms(torch, lambda: chol_dist.cholesky_dist(mesh, A,
                                                                   blk), 3)
        ms_ref = _event_ms(torch, lambda: torch.linalg.cholesky(A), 3)
        ok = l_err <= CHOL_DIST_TOL and ld_err <= CHOL_DIST_LOGDET_RTOL
        bad += [] if ok else ["cholesky_dist"]
        log(f"[dist] {smi} | cholesky_dist N={Nc} f64 block {blk}: factor "
            f"{l_err:.3e} of max|L| (limit {CHOL_DIST_TOL:.0e}), logdet rel "
            f"{ld_err:.3e} (limit {CHOL_DIST_LOGDET_RTOL:.0e}); "
            f"{ms_dist:.3f} ms, torch.linalg.cholesky {ms_ref:.3f} ms "
            f"{'ok' if ok else 'FAIL'}")
        out["cholesky"] = dict(factor_rel=l_err, logdet_rel=ld_err,
                               ms=ms_dist, cholesky_ms=ms_ref)
        del A, L_loc, L_ref
        torch.cuda.empty_cache()

        # -- solver="dense_dist" at N = 4092 (padded to 4096) --------------
        nd = 372
        x2, f2, g2_, xt2, _, _ = _rosen_problem(rosenbrock, nd, d, seed=3)
        def fit_predict(solver):
            gp_ = _fit(GaussianProcess, x2, f2, g2_, solver=solver,
                       cond_norm="fro")
            return gp_, gp_.eval_model(xt2)[0]

        fits = {}
        for solver in ("dense", "dense_dist"):
            fit_predict(solver)     # the first fit at this size, untimed
            (gp, mu), secs, counts = _path(
                torch, ca, f"[dist] solver={solver} d=10 n_eval={nd} warm "
                "fit + predict", lambda: fit_predict(solver))
            fits[solver] = (gp, mu, secs, counts)
        gpd, mud, td, cd = fits["dense"]
        gpm, mum, tm, cm = fits["dense_dist"]
        lnl_rel = abs(gpm.history.ln_lkd[0] - gpd.history.ln_lkd[0]) / abs(
            gpd.history.ln_lkd[0])
        mu_rel = _rel(mum, mud)
        info = gpm.optz_infos[0]
        ok = (lnl_rel <= DD_LNL_RTOL and mu_rel <= DD_MU_RTOL
              and gpm.spec.n_data_tot == 4096)
        bad += [] if ok else ["dense_dist fit"]
        log(f"[dist] {smi} | solver=dense_dist d=10 n_eval={nd} (N "
            f"{nd * (d + 1)} padded to {gpm.spec.n_data_tot}): warm fit + "
            f"predict {tm:.3f} s (dense {td:.3f} s), L-BFGS "
            f"{info['hp_optz_iter_max']:.0f} iterations (dense "
            f"{gpd.optz_infos[0]['hp_optz_iter_max']:.0f}), K1/K2 {cm} (dense "
            f"{cd}); -lnL {-gpm.history.ln_lkd[0]:.10g} rel {lnl_rel:.3e} "
            f"(limit {DD_LNL_RTOL:.0e}), mu at 128 points rel {mu_rel:.3e} "
            f"(limit {DD_MU_RTOL:.0e}); mesh devices "
            f"{info['dist_mesh_devices']}, block {info['dist_chol_block']} "
            f"{'ok' if ok else 'FAIL'}")
        out["dense_dist"] = dict(s=tm, dense_s=td, lnl_rel=lnl_rel,
                                 mu_rel=mu_rel, launches=cm,
                                 dense_launches=cd,
                                 lbfgs_iters=info["hp_optz_iter_max"])
        del fits, gpd, gpm
        torch.cuda.empty_cache()

        # -- sample_posterior(use_mesh=True) at d=10, n_eval=200 -----------
        x3, f3, g3, _, _, _ = _rosen_problem(rosenbrock, 200, d)
        gp = _fit(GaussianProcess, x3, f3, g3)
        (hp_mesh, diag), secs, counts = _path(
            torch, ca, "[dist] sample_posterior(use_mesh=True) 8 chains",
            lambda: gp.sample_posterior(8, seed=0, use_mesh=True,
                                        **DIST_NUTS))
        logpost, z_to_hp, z0 = gp._posterior_setup(8, 0)
        zs, _ = nuts.run_nuts(logpost, z0, Draws(0, "cuda"),
                              cross_chain_mean=nuts.chain_mean, **DIST_NUTS)
        want = z_to_hp(zs).cpu().numpy()
        bvec = gp.hp_info_optz_lkd.bvec_log
        want[..., bvec] = 10.0 ** want[..., bvec]
        err = _rel(hp_mesh, want)
        rate = 8 * DIST_NUTS["n_samples"] / secs
        ok = err <= DIST_NUTS_TOL and bool(np.all(np.isfinite(hp_mesh)))
        bad += [] if ok else ["sample_posterior(use_mesh=True)"]
        log(f"[dist] {smi} | sample_posterior(use_mesh=True) 8 chains, "
            f"{DIST_NUTS}: {secs:.3f} s, {rate:.3f} samples/s (warmup "
            f"included), against run_nuts with pooled adaptation rel "
            f"{err:.3e} (limit {DIST_NUTS_TOL:.0e}); leapfrogs per chain "
            f"{diag['n_leapfrog'].sum(1).tolist()} {'ok' if ok else 'FAIL'}")
        out["nuts"] = dict(s=secs, samples_per_s=rate, rel=err,
                           launches=counts)
        del gp
        torch.cuda.empty_cache()

        # -- the examples' compute parts -----------------------------------
        demo, secs, counts = _path(
            torch, ca, "[dist] large_n_demo --n 2048 --dim 4, 3 steps",
            lambda: large_n_demo.compute(2048, 4, 3, device="cuda"))
        # the demo's own CG caps (400 in the fit, 300 in the predict) stop
        # short of the tolerance at cond 1e6 and N = 10 240, as in the JAX
        # example: its numbers are held to be finite, not converged
        ok = (all(np.all(np.isfinite(demo[k]))
                  for k in ("neg_lnL", "theta", "mu", "sig"))
              and demo["world_size"] == 1 and demo["backend"] == "nccl")
        bad += [] if ok else ["large_n_demo"]
        log(f"[dist] {smi} | large_n_demo: " + json.dumps(
            {k: v for k, v in demo.items() if k not in ("mu", "sig")}))
        out["large_n_demo"] = dict(
            {k: v for k, v in demo.items() if k not in ("mu", "sig")},
            s=secs, launches=counts)
        t0 = time.perf_counter()
        harness = scaling_harness.compute((1,), chains=8, samples=8,
                                          warmup=8, starts=8, device="cuda")
        secs = time.perf_counter() - t0
        pt = harness["points"][0]
        ok = (harness["backend"] == "nccl" and pt["shared_device"] is False
              and min(pt["launches"].values()) > 0
              and harness["meets_70pct_target"] is False)
        bad += [] if ok else ["scaling_harness"]
        log(f"[dist] {smi} | scaling_harness world size 1 ({secs:.1f} s, "
            f"K1/K2 in its rank {pt['launches']}): " + json.dumps(harness))
        out["scaling_harness"] = dict(harness, s=secs)
    finally:
        dist.destroy_process_group()
    if bad:
        raise SystemExit(f"[dist] failed: {bad}")
    return out


def _time_ms(torch, fn, reps, flush):
    """Mean device time of fn over reps calls, L2 flushed before each."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def phase_times(torch, ca, KernGradFn):
    """Kernel rows {(name, batch): times} and the context times {name: ms}."""
    rng = np.random.default_rng(1)
    # 512 MB: larger than the 50 MB L2, and its clearing keeps the card busy
    # while the host enqueues the timed call, so the events time the device
    flush = torch.empty(2 ** 29, dtype=torch.uint8, device="cuda")
    rows, ctx = {}, {}
    d, n = 10, 200
    for B in (None, 41):
        x1, x2, th, al, gb = _inputs(torch, rng, n, n, d, B, torch.float64,
                                     "SqExp", True)
        nb = 1 if B is None else B
        reps = 20 if B is None else 5
        fns = {
            "K1": (lambda: ca.kern_grad("SqExp", x1, x1, th),
                   lambda: ca.kern_grad_plain("SqExp", x1, x1, th)),
            "K2": (lambda: ca.kern_grad_vjp_theta("SqExp", x1, x1, th, None, gb),
                   lambda: ca.kern_grad_vjp_theta_plain("SqExp", x1, x1, th,
                                                        None, gb)),
        }
        for name, (kern, plain) in fns.items():
            ms = _time_ms(torch, kern, reps, flush)
            plain_ms = _time_ms(torch, plain, reps, flush)
            A2 = (d + 1) ** 2
            nbytes = nb * A2 * n * n * 8 + (2 * n * d + nb * d + nb) * 8
            pairs = nb * n * n
            nflop = pairs * (3 * d + 12 + (6 if name == "K1" else 12) * A2)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nflop / PEAK_FLOPS["float64"] * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, flops=nflop)
            rows[(name, nb)] = row
            log(f"[time] {name} SqExp f64 n=200 d=10 B={nb}: {ms:.4f} ms "
                f"(bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"{nbytes / ms / 1e6:.1f} GB/s = "
                f"{100 * row['bound_ms'] / ms:.1f}% of bound; first port "
                f"{FIRST_PORT_MS[(name, nb)]:.4f} ms = "
                f"{100 * row['bound_ms'] / FIRST_PORT_MS[(name, nb)]:.1f}%) | plain "
                f"{plain_ms:.4f} ms | library call: none computes this function")
        del x1, x2, th, gb

    # the iterative path's row tile: 256 points against n_eval=2000 (the
    # [iterative-large] matvec launches 8 of these per CG iteration), and
    # the tile's product with 17 (a fit's solves) and 128 (predict) columns
    n1, n2 = 256, 2000
    x1, x2, th, _, gb = _inputs(torch, rng, n1, n2, d, None, torch.float64,
                                "SqExp", False)
    A2 = (d + 1) ** 2
    nbytes = A2 * n1 * n2 * 8 + ((n1 + n2) * d + d) * 8
    for name, kern, plain, k in (
            ("K1", lambda: ca.kern_grad("SqExp", x1, x2, th),
             lambda: ca.kern_grad_plain("SqExp", x1, x2, th), 6),
            ("K2", lambda: ca.kern_grad_vjp_theta("SqExp", x1, x2, th, None,
                                                  gb),
             lambda: ca.kern_grad_vjp_theta_plain("SqExp", x1, x2, th, None,
                                                  gb), 12)):
        ms = _time_ms(torch, kern, 10, flush)
        plain_ms = _time_ms(torch, plain, 3, flush)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n1 * n2 * (3 * d + 12 + k * A2) / PEAK_FLOPS["float64"] * 1e3
        rows[(name, "tile")] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"[time] {name} SqExp f64 row tile n1={n1} n2={n2} d={d}: "
            f"{ms:.4f} ms (bound {max(t_bytes, t_ops):.4f} ms, "
            f"{100 * max(t_bytes, t_ops) / ms:.1f}% of bound) | plain "
            f"{plain_ms:.4f} ms")
    Kt = ca.kern_grad("SqExp", x1, x2, th)
    for m in (17, 128):
        V = torch.as_tensor(rng.standard_normal((Kt.shape[1], m)),
                            device="cuda")
        ctx[f"tile_matmul_{m}_ms"] = _time_ms(torch, lambda: Kt @ V, 10, flush)
        log(f"[time] context: the row tile @ V ({m} columns), torch.matmul "
            f"f64: {ctx[f'tile_matmul_{m}_ms']:.4f} ms")
    del x1, x2, th, gb, Kt, V

    # what one PyTorch call takes to write (fill_) and to read (sum) as many
    # bytes as the kernels move: context for the bound, not a library
    # version of either kernel
    for B in (1, 41):
        buf = torch.empty((B, (d + 1) * n, (d + 1) * n), dtype=torch.float64,
                          device="cuda")
        ctx[f"fill_B{B}_ms"] = _time_ms(torch, lambda: buf.fill_(1.0), 10, flush)
        ctx[f"sum_B{B}_ms"] = _time_ms(torch, lambda: buf.sum(), 10, flush)
        log(f"[time] context: the same {buf.numel() * 8 / 1e6:.1f} MB in one "
            f"PyTorch call, B={B}: fill_ (write) {ctx[f'fill_B{B}_ms']:.4f} ms,"
            f" sum (read) {ctx[f'sum_B{B}_ms']:.4f} ms")
        del buf

    # KernGradFn forward + backward for RatQu at the same shape: the theta
    # cotangent alone (K1 + K2) against theta and alpha (K1 + K2 + autograd
    # of the plain closed form for alpha), which a fit with alpha fitted
    # runs once per objective gradient
    x1, _, th, al, gb = _inputs(torch, rng, n, n, d, None, torch.float64,
                                "RatQu", True)

    def fwd_bwd(with_alpha):
        t = th.detach().requires_grad_(True)
        a = al.detach().requires_grad_(with_alpha)
        K = KernGradFn.apply("RatQu", x1, t, a)
        return torch.autograd.grad(K, [t, a] if with_alpha else [t], gb)
    ctx["ratqu_theta_ms"] = _time_ms(torch, lambda: fwd_bwd(False), 10, flush)
    ctx["ratqu_alpha_ms"] = _time_ms(torch, lambda: fwd_bwd(True), 10, flush)
    log(f"[time] KernGradFn RatQu f64 n=200 d=10 forward + backward: theta "
        f"only {ctx['ratqu_theta_ms']:.4f} ms, theta and alpha "
        f"{ctx['ratqu_alpha_ms']:.4f} ms")
    del x1, th, al, gb

    N = (d + 1) * n
    A = torch.as_tensor(rng.standard_normal((N, N)), device="cuda")
    A = A @ A.T + N * torch.eye(N, dtype=A.dtype, device="cuda")
    ctx["chol_ms"] = _time_ms(torch, lambda: torch.linalg.cholesky_ex(A), 10,
                               flush)
    log(f"[time] context: torch.linalg.cholesky_ex f64 {N}x{N}: "
        f"{ctx['chol_ms']:.4f} ms")
    return rows, ctx


def phase_fit_repeats(torch, GaussianProcess, rosenbrock, reps=5):
    """The warm d=10 fit repeated in this process: wall seconds of each."""
    d, n = 10, 200
    x, f, g, _, _, _ = _rosen_problem(rosenbrock, n, d)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _fit(GaussianProcess, x, f, g)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[repeat] warm fit d=10 n_eval=200 x{reps}: median "
        f"{np.median(walls):.3f} s, min {min(walls):.3f} s, max "
        f"{max(walls):.3f} s ({', '.join(f'{w:.3f}' for w in walls)})")
    return walls


GROUPS = (  # kernel-name keywords -> layer, for the fit's time breakdown
    ("K1 covariance assembly", ("kern_grad_kernel",)),
    ("K2 theta-cotangent", ("kern_vjp_theta",)),
    ("Cholesky (potrf)", ("potrf", "getrf")),
    ("condition number (eigh)", ("syevd", "syev", "sytrd", "stedc", "orgtr",
                                 "ormtr", "steqr", "sterf", "latrd", "larf")),
    ("triangular solves / products", ("trsm", "trsv", "gemm", "gemv", "syrk",
                                      "herk", "trmm", "dot")),
)


ITER_GROUPS = (  # the same for one iterative objective
    ("K1 covariance row tiles", ("kern_grad_kernel",)),
    ("K2 theta-cotangent", ("kern_vjp_theta",)),
    ("K tile x V products (gemm)", ("gemm", "gemv", "cutlass", "dot")),
    ("SLQ tridiagonal eigh", ("syevd", "syev", "sytrd", "stedc", "orgtr",
                              "ormtr", "steqr", "sterf", "latrd", "larf",
                              "syevj")),
)


def phase_profile(torch, GaussianProcess, rosenbrock, wellcond="precon"):
    """One warm d=10 fit of the given method under torch.profiler (see
    profile_fn)."""
    d, n = 10, 200
    x, f, g, _, _, _ = _rosen_problem(rosenbrock, n, d)
    return profile_fn(torch, f"warm {wellcond} fit d=10 n_eval=200",
                      lambda: _fit(GaussianProcess, x, f, g,
                                   wellcond=wellcond), GROUPS)


def profile_fn(torch, label, fn, groups):
    """fn() under torch.profiler: device time by layer (groups) and by
    kernel, and the device's busy share of the same run's wall time.
    Returns {device_ms, wall_ms, idle_share, layers_ms}, or None where the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies); the CPU-side aten ops also
    # report the device time of what they launched, which would count twice
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
              and "Buffer Flush" not in e.key]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        log(f"[profile] {label}: the profiler recorded no device time: "
            f"not measured")
        return None
    log(f"[profile] {label} under the profiler: "
        f"wall {wall_ms:.1f} ms, device busy {dev_ms:.1f} ms "
        f"({100 * dev_ms / wall_ms:.1f}%), idle {100 * (1 - dev_ms / wall_ms):.1f}%")
    grouped = {name: 0.0 for name, _ in groups}
    grouped["other device work"] = 0.0
    for e in events:
        key = next((name for name, kws in groups
                    if any(k in e.key.lower() for k in kws)), "other device work")
        grouped[key] += e.self_device_time_total / 1e3
    for name, ms in sorted(grouped.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {name:32s} {ms:9.2f} ms {100 * ms / dev_ms:5.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   top {e.self_device_time_total / 1e3:8.2f} ms "
            f"x{e.count:5d} {e.key[:90]}")
    return {"device_ms": dev_ms, "wall_ms": wall_ms,
            "idle_share": 1 - dev_ms / wall_ms, "layers_ms": grouped}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gpgradpy_torch import GaussianProcess
    from gpgradpy_torch.bo.problems import rosenbrock
    import gpgradpy_torch as tgp
    from gpgradpy_torch.model import likelihood_iter as tli
    from gpgradpy_torch.model.assembly import KernGradFn
    from gpgradpy_torch.ops import cuda_assembly as ca
    from gpgradpy_torch.ops import iterative as it

    t_start = time.perf_counter()
    phase_s = {}
    # phases named on the command line run alone (after card and build),
    # without the closing lines; with no argument every phase runs
    only = set(sys.argv[1:])

    def phase(name, fn, *args, **kw):
        if only and name not in only | {"card", "build"}:
            return None
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        phase_s[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {phase_s[name]:.1f} s")
        return res

    smi = phase("card", phase_card, torch)
    phase("build", phase_build, ca)
    worst = phase("kernel checks", phase_kernels, torch, ca)
    main_out = phase("main path", phase_main, torch, ca, GaussianProcess,
                     rosenbrock)
    cons = phase("constrained", phase_constrained, torch, ca,
                 GaussianProcess, rosenbrock)
    mv_err = phase("matvec check", phase_matvec_check, torch, ca, it, tli,
                   tgp)
    itr = phase("iterative", phase_iterative, torch, ca, it, GaussianProcess,
                rosenbrock)
    prof_iter = phase("profile iterative objective", profile_iter_objective,
                      torch, it, tli, *(itr.pop(k) for k in ("gp", "fit_cfg"))
                      ) if itr else None
    large = phase("iterative-large", phase_iterative_large, torch, ca, it,
                  tli, GaussianProcess, rosenbrock,
                  np.asarray(itr["theta"])) if itr else None
    cvc = phase("iterative card vs cpu", phase_iterative_card_vs_cpu, torch,
                ca, GaussianProcess)
    nuts_d10 = phase("nuts-d10", phase_nuts_d10, torch, ca, GaussianProcess,
                     rosenbrock)
    nuts_256 = phase("nuts-256", phase_nuts_256, torch, ca, tgp, rosenbrock)
    vi_smc = phase("advi and smc", phase_advi_smc, torch, ca, tgp, rosenbrock)
    bo_d10 = phase("bo-d10", phase_bo_d10, torch, ca, GaussianProcess,
                   rosenbrock)
    polish = phase("polish", phase_polish, torch, ca, GaussianProcess,
                   rosenbrock, smi)
    utils = phase("utils", phase_utils, torch, ca, GaussianProcess,
                  rosenbrock, smi)
    examples = phase("examples", phase_examples, torch, ca, smi)
    dist_out = phase("dist", phase_dist, torch, ca, GaussianProcess,
                     rosenbrock, smi)
    rows, ctx = phase("kernel times", phase_times, torch, ca,
                      KernGradFn) or (None, None)
    walls = phase("fit repeats", phase_fit_repeats, torch, GaussianProcess,
                  rosenbrock)
    prof = phase("profile precon", phase_profile, torch, GaussianProcess,
                 rosenbrock)
    prof_base = phase("profile base", phase_profile, torch, GaussianProcess,
                      rosenbrock, wellcond="base")

    if only:
        log("[summary] " + json.dumps({
            "phase_s": phase_s, "bo_d10": bo_d10, "polish": polish,
            "utils": utils, "examples": examples, "dist": dist_out}))
        return 0

    # the results in one line near the end, so that a cut-off tail keeps them
    summary = {
        "card": smi,
        "d10_first_fit_s": main_out["t_first"],
        "d10_warm_fit_s": main_out["t_warm"],
        "d10_warm_fit_repeats_s": walls,
        "d10_neg_lnL": main_out["neg_lnL"],
        "d10_lbfgs_iters": main_out["iters"],
        "launches": {"d10 warm fit + predict": main_out["launches"],
                     "d10 RatQu warm fit": main_out["ratqu_launches"],
                     "bench d4 fit + predict": main_out["bench_launches"]},
        "ratqu_warm_fit_s": main_out["t_ratqu"],
        "ms_per_objective_gradient": {"SqExp": main_out["sqexp_ms_per_grad"],
                                      "RatQu": main_out["ratqu_ms_per_grad"]},
        "kerngradfn_ratqu_ms": {"theta": ctx["ratqu_theta_ms"],
                                "theta+alpha": ctx["ratqu_alpha_ms"]},
        "bench_rmse": main_out["rmse_bench"],
        "kernel_ms": {f"{k}_B{b}": {kk: r[kk] for kk in ("ms", "plain_ms",
                                                         "bound_ms")}
                      for (k, b), r in rows.items()},
        "cholesky_ms": ctx["chol_ms"],
        "row_tile_matmul_ms": {k: v for k, v in ctx.items()
                               if k.startswith("tile_matmul")},
        "same_bytes_one_torch_call_ms": {k: v for k, v in ctx.items()
                                         if k.startswith(("fill_", "sum_"))},
        "constrained_d10": cons,
        "matvec_check_f64_sqexp": mv_err,
        "iterative_d10": itr,
        "iterative_large_d10_n2000": large,
        "iterative_card_vs_cpu": cvc,
        "nuts_d10": nuts_d10,
        "nuts_256": nuts_256,
        "advi_smc": vi_smc,
        "bo_d10": bo_d10,
        "polish": polish,
        "utils": utils,
        "examples": examples,
        "dist": dist_out,
        "phase_s": phase_s,
    }
    if prof_iter is not None:
        summary["profiled_iterative_objective"] = prof_iter
    if prof is not None:
        summary["profiled_fit"] = {k: prof[k] for k in (
            "device_ms", "wall_ms", "idle_share")}
    if prof_base is not None:
        summary["profiled_base_fit"] = prof_base
    log("[summary] " + json.dumps(summary))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    names = {"K1": "kern_grad (gradient-enhanced covariance)",
             "K2": "kern_grad_vjp_theta (theta-cotangent of K1)"}
    kernels = []
    for k in ("K1", "K2"):
        r = rows[(k, 1)]
        kernels.append({
            "name": f"{k} {names[k]}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[k], "launches": main_out["launches"][k],
            "max_abs_err": worst[k], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
