"""Paper reproduction: gradient-enhanced BO on Rosenbrock (a=10) comparing
the Baseline / Rescaling / Precondition conditioning methods, next to the
paper's bundled traces when ``--ref-data`` names them (counterpart of
``examples/optz_paper_precon.py``).  The traces come from the port's
``bo.loop.run_bo_multistart`` in the JAX package's npz schema.

    python -m gpgradpy_torch.examples.optz_paper_precon --dim 5 --n-iter 60 --n-x0 3 [--device cpu]
"""

import argparse
import os
from functools import partial

import numpy as np

from gpgradpy_torch.bo import loop, problems
from gpgradpy_torch.results import PltOptzResults

from . import run_paper_traces
from .run_paper_traces import WELLCOND_BY_METHOD


def compute(dim=5, n_iter=60, n_x0=3, methods=("Baseline", "Precondition"),
            out_dir="bo_results", device="cuda", ref_data=None):
    """Run the BO traces of each method; print their medians (and the
    paper's, from the ``ref_data`` directory where given and present);
    returns (merit, opt) of PltOptzResults."""
    obj = partial(problems.rosenbrock, a=10.0)
    lb, ub = np.full(dim, -2.0), np.full(dim, 2.0)
    os.makedirs(out_dir, exist_ok=True)

    for method in methods:
        out_npz = run_paper_traces.all_path(out_dir, dim, method)
        print(f"=== {method} ({WELLCOND_BY_METHOD[method]}) -> {out_npz}")
        loop.run_bo_multistart(
            obj, lb, ub, n_iter=n_iter, n_x0=n_x0, n_init=dim + 2,
            wellcond_mtd=WELLCOND_BY_METHOD[method], acq="ei",
            exploit_frac=0.5, exploit_local=True, save_path=out_npz,
            gp_options={"device": device}, verbose=True)

    _, merit, opt = run_paper_traces.summarize(dim, out_dir, list(methods),
                                               ref_data)
    return merit, opt


def plot(merit, opt, methods, dim, out_dir):
    PltOptzResults.plt_conv_nx0(
        merit, list(methods), os.path.join(out_dir, f"conv_merit_d{dim}.png"),
        ylabel="merit")
    PltOptzResults.plt_conv_nx0(
        opt, list(methods), os.path.join(out_dir, f"conv_opt_d{dim}.png"),
        ylabel=r"$\|\nabla f\|_2$")
    print(f"plots in {out_dir}/")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=5)
    ap.add_argument("--n-iter", type=int, default=60)
    ap.add_argument("--n-x0", type=int, default=3)
    ap.add_argument("--methods", nargs="+",
                    default=["Baseline", "Precondition"])
    ap.add_argument("--out-dir", default="bo_results")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ref-data", default=None,
                    help="the paper's bundled traces (data_paper_precon/)")
    args = ap.parse_args(argv)
    merit, opt = compute(args.dim, args.n_iter, args.n_x0, args.methods,
                         args.out_dir, args.device, args.ref_data)
    plot(merit, opt, args.methods, args.dim, args.out_dir)


if __name__ == "__main__":
    main()
