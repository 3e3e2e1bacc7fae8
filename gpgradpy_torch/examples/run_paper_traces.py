"""Runner of the paper-parity BO quality traces (counterpart of
``examples/run_paper_traces.py``).

Produces the Rosenbrock (a=10) gradient-enhanced BO traces of the
Baseline / Rescaling / Precondition conditioning methods in float64, in
the npz schema of the JAX package's runner, so that
``gpgradpy_torch.results.PltOptzResults`` reads them beside the JAX
package's traces (``results_data/``) and the paper's.

Worker mode (one (method, start) per process; parallelize externally):
  python -m gpgradpy_torch.examples.run_paper_traces --dim 5 --worker Precondition 0
Merge mode (stack the per-start npz into the merged schema):
  python -m gpgradpy_torch.examples.run_paper_traces --dim 5 --merge --out-dir results_data/port_d5
Summary mode (medians, plots, and the paper's bundled traces when
``--ref-data`` names their ``data_paper_precon/`` directory):
  python -m gpgradpy_torch.examples.run_paper_traces --dim 5 --summary --out-dir results_data/port_d5
Every mode runs its GPs on ``--device`` (cuda, or cpu).
"""

import argparse
import os
import time
import zipfile
from functools import partial

import numpy as np

from gpgradpy_torch.bo import loop, problems
from gpgradpy_torch.results import PltOptzResults

WELLCOND_BY_METHOD = {
    "Baseline": "base",
    "Rescaling": "rescale_origin",
    "Precondition": "precon",
}
REF_FILES = {
    "Baseline": "Baye_Kern_SE_n500_Grad_T_None_all.npz",
    "Rescaling": "Baye_Kern_SE_n500_Grad_T_Vreq_all.npz",
    "Precondition": "Baye_Kern_SE_n500_Grad_T_Precon_all.npz",
}
METHODS = list(WELLCOND_BY_METHOD)


def start_path(out_dir, dim, method, j):
    return os.path.join(out_dir, f"Rosen_a10_d{dim}_{method}_s{j}.npz")


def all_path(out_dir, dim, method):
    return os.path.join(out_dir, f"Rosen_a10_d{dim}_{method}_all.npz")


def run_one(dim, method, j, n_iter, out_dir, seed0=0, variant="default",
            cond_norm=None, device="cuda"):
    """One (method, start) trace, checkpointed to its per-start npz every 4
    iterations and resumed from it.  variant:
    - 'default': exploit cascade on, the local trust-region GP
      preconditioned for every method;
    - 'honest': exploit cascade on, the local GP runs the named method;
    - 'noexploit': cascade off, pure EI through the named method;
    - 'noexploit_lcb': cascade off, the lower-confidence bound mu - 2 sigma.
    """
    obj = partial(problems.rosenbrock, a=10.0)
    lb, ub = np.full(dim, -2.0), np.full(dim, 2.0)
    path = start_path(out_dir, dim, method, j)
    kw = dict(exploit_frac=0.5, exploit_local=True, exploit_wellcond="precon")
    acq = "ei"
    if variant == "honest":
        kw["exploit_wellcond"] = None
    elif variant == "noexploit":
        kw = dict(exploit_frac=0.0, exploit_local=False)
    elif variant == "noexploit_lcb":
        kw = dict(exploit_frac=0.0, exploit_local=False)
        acq = "ucb"
    kw["gp_options"] = {"device": device}
    if cond_norm:
        # 'fro': the Cholesky-based Frobenius condition number; at d=10+ the
        # spectral (eigh) cond costs seconds per SLSQP evaluation, and
        # cond_fro >= cond_2 keeps the cond <= 1e10 constraint conservative
        kw["gp_options"]["cond_norm"] = cond_norm

    def cb(partial_trace, completed=False):
        np.savez(path, x_all=partial_trace.x_all,
                 merit_all=partial_trace.merit_all,
                 opt_all=partial_trace.opt_all,
                 fsb_all=partial_trace.fsb_all,
                 time_iter=partial_trace.time_iter,
                 variant=np.str_(variant),
                 completed=np.bool_(completed))

    # resume from a partial checkpoint: replay the recorded prefix
    resume = None
    if os.path.isfile(path):
        try:
            z = np.load(path, allow_pickle=True)
            if "completed" in z and bool(z["completed"]):
                print(f"[{method} start {j}] already completed; skipping")
                return
            if z["merit_all"].size == dim + 2 + n_iter:
                resume = loop.BoTrace(
                    x_all=z["x_all"], merit_all=z["merit_all"],
                    opt_all=z["opt_all"], fsb_all=z["fsb_all"],
                    time_iter=z["time_iter"])
                n_fin = int(np.isfinite(z["merit_all"]).sum())
                print(f"[{method} start {j}] resuming from checkpoint "
                      f"({n_fin} evaluations recorded)")
            else:
                # another --n-iter: refuse rather than let the fresh run's
                # first checkpoint overwrite the recorded progress
                raise SystemExit(
                    f"[{method} start {j}] checkpoint {path} holds "
                    f"{z['merit_all'].size - dim - 2} iterations but "
                    f"--n-iter {n_iter} was requested; re-run with "
                    f"--n-iter {z['merit_all'].size - dim - 2} to resume "
                    f"it, or delete the file to start fresh")
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            print(f"[{method} start {j}] checkpoint unreadable ({e}); "
                  f"starting fresh")

    t0 = time.time()
    trace = loop.run_bo(
        obj, lb, ub, n_iter, n_init=dim + 2,
        wellcond_mtd=WELLCOND_BY_METHOD[method], acq=acq,
        seed=seed0 + j, verbose=True, checkpoint_cb=cb,
        checkpoint_every=4, resume_trace=resume, **kw)
    cb(trace, completed=True)
    m = trace.merit_all[np.isfinite(trace.merit_all)]
    o = trace.opt_all[np.isfinite(trace.opt_all)]
    print(f"[{method} start {j}] done in {time.time()-t0:.0f}s: "
          f"best merit {np.min(m):.3e}, best opt {np.min(o):.3e}")
    return trace


def merge(dim, out_dir, n_x0, methods):
    """Stack each method's per-start npz into its merged npz."""
    for method in methods:
        paths = [start_path(out_dir, dim, method, j) for j in range(n_x0)]
        paths = [p for p in paths if os.path.isfile(p)]
        if not paths:
            print(f"[merge] no per-start files for {method}; skipped")
            continue
        runs = [np.load(p) for p in paths]
        n_tot = max(r["merit_all"].size for r in runs)
        dim_x = runs[0]["x_all"].shape[1]

        def pad(a, fill=np.nan):
            out = np.full((len(runs),) + (n_tot,) + a(runs[0]).shape[1:], fill)
            for i, r in enumerate(runs):
                v = a(r)
                out[i, :v.shape[0]] = v
            return out

        x0_all = pad(lambda r: r["x_all"])
        merit = pad(lambda r: r["merit_all"])
        opt = pad(lambda r: r["opt_all"])
        fsb = pad(lambda r: r["fsb_all"])
        out = all_path(out_dir, dim, method)
        np.savez(out, x0_all=x0_all, merit_all=merit, opt_all=opt,
                 fsb_all=fsb, merit_wo_noise_all=merit,
                 opt_wo_noise_all=opt, fsb_wo_noise_all=fsb)
        print(f"[merge] {out}: {len(runs)} starts x {n_tot} iters "
              f"(dim {dim_x})")


def summarize(dim, out_dir, methods, ref_data=None):
    """Print the medians of the merged traces (and of the paper's, from the
    ``ref_data`` directory where given and present); returns (names,
    merit, opt) for ``plot``."""
    names = [m for m in methods if os.path.isfile(all_path(out_dir, dim, m))]
    merit = opt = None
    if names:
        files = [os.path.basename(all_path(out_dir, dim, m)) for m in names]
        merit, opt, _ = PltOptzResults.load_npz_data(out_dir, files,
                                                     n_iter_max=None)
        mm, mo = PltOptzResults.summarize(merit, opt)
        for m, a, b in zip(names, mm, mo):
            print(f"[ours]  {m:13s}: best merit (median) = {a:.3e}, "
                  f"best ||grad|| (median) = {b:.3e}")
    ref_dir = ref_data and os.path.join(ref_data, f"Rosen_a10_d{dim}")
    if ref_dir and os.path.isdir(ref_dir):
        ref_files = [REF_FILES[m] for m in names
                     if os.path.isfile(os.path.join(ref_dir, REF_FILES[m]))]
        if ref_files:
            rm, ro, _ = PltOptzResults.load_npz_data(ref_dir, ref_files,
                                                     n_iter_max=None)
            rmm, rmo = PltOptzResults.summarize(rm, ro)
            for m, a, b in zip(names, rmm, rmo):
                print(f"[paper] {m:13s}: best merit (median) = {a:.3e}, "
                      f"best ||grad|| (median) = {b:.3e}")
    return names, merit, opt


def plot(dim, out_dir, names, merit, opt):
    if not names:
        return
    PltOptzResults.plt_conv_nx0(
        merit, names, os.path.join(out_dir, f"conv_merit_d{dim}.png"),
        ylabel="merit")
    PltOptzResults.plt_conv_nx0(
        opt, names, os.path.join(out_dir, f"conv_opt_d{dim}.png"),
        ylabel=r"$\|\nabla f\|_2$")


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--n-iter", type=int, default=150)
    ap.add_argument("--n-x0", type=int, default=5)
    # a directory of its own: results_data/full_d5 holds the JAX package's
    # traces, which a merge or a plot here would overwrite
    ap.add_argument("--out-dir", default="results_data/port_d5")
    ap.add_argument("--methods", nargs="+", default=METHODS)
    ap.add_argument("--worker", nargs=2, metavar=("METHOD", "START"))
    ap.add_argument("--variant", default="default",
                    choices=["default", "honest", "noexploit",
                             "noexploit_lcb"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--cond-norm", default=None,
                    help="override GpConfig.cond_norm (e.g. 'fro' for d>=10)")
    ap.add_argument("--merge", action="store_true")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--ref-data", default=None,
                    help="the paper's bundled traces (data_paper_precon/); "
                         "without it the summary skips them")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.worker:
        method, j = args.worker[0], int(args.worker[1])
        if method not in WELLCOND_BY_METHOD:
            raise SystemExit(f"unknown method {method}; one of {METHODS}")
        run_one(args.dim, method, j, args.n_iter, args.out_dir,
                variant=args.variant, cond_norm=args.cond_norm,
                device=args.device)
        return
    if args.merge:
        merge(args.dim, args.out_dir, args.n_x0, args.methods)
    if args.summary or args.merge:
        plot(args.dim, args.out_dir, *summarize(
            args.dim, args.out_dir, args.methods, args.ref_data))
        return
    # serial: every (method, start) in this process
    for method in args.methods:
        for j in range(args.n_x0):
            run_one(args.dim, method, j, args.n_iter, args.out_dir,
                    variant=args.variant, cond_norm=args.cond_norm,
                    device=args.device)
    merge(args.dim, args.out_dir, args.n_x0, args.methods)
    plot(args.dim, args.out_dir, *summarize(
        args.dim, args.out_dir, args.methods, args.ref_data))


if __name__ == "__main__":
    main()
