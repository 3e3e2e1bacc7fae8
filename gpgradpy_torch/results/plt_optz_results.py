"""Loading and convergence-plotting of BO result traces (the port's copy
of ``gpgradpy_tpu/results/plt_optz_results.py``, numpy and matplotlib
only).  Reads the npz schema that ``bo.loop.run_bo_multistart`` writes in
both packages (merit_all / opt_all / fsb_all (+ _wo_noise variants), shape
(n_x0, n_iter)), so the port's traces and the corpora under
``results_data/`` load through one reader.
"""

from __future__ import annotations

from os import path
from typing import Optional, Sequence

import numpy as np


class PltOptzResults:

    @staticmethod
    def load_npz_data(case_folder: str, file_vec: Sequence[str],
                      n_iter_max: Optional[int] = 1000, n_x0_init: int = 20,
                      load_noise_free_data: bool = True):
        """(PltOptzResults.load_npz_data, PltOptzResults.py:22-70)."""
        b_clip = n_iter_max is None
        if n_iter_max is None:
            n_iter_max = 1000
        n_files = len(file_vec)
        merit_all = np.full((n_files, n_x0_init, n_iter_max), np.nan)
        opt_all = np.full((n_files, n_x0_init, n_iter_max), np.nan)
        fsb_all = np.full((n_files, n_x0_init, n_iter_max), np.nan)

        n_x0_max = 0
        true_iter_max = 0
        for i, fname in enumerate(file_vec):
            npz = np.load(path.join(case_folder, fname))
            merit = npz["merit_all"]
            n_x0_i, n_iter_i = merit.shape
            n_iter_i = min(n_iter_i, n_iter_max)
            sfx = "_wo_noise_all" if load_noise_free_data else "_all"
            merit_all[i, :n_x0_i, :n_iter_i] = npz["merit" + sfx][:, :n_iter_i]
            opt_all[i, :n_x0_i, :n_iter_i] = npz["opt" + sfx][:, :n_iter_i]
            fsb_all[i, :n_x0_i, :n_iter_i] = npz["fsb" + sfx][:, :n_iter_i]
            n_x0_max = max(n_x0_max, n_x0_i)
            true_iter_max = max(true_iter_max, n_iter_i)

        if b_clip:
            return (merit_all[:, :n_x0_max, :true_iter_max],
                    opt_all[:, :n_x0_max, :true_iter_max],
                    fsb_all[:, :n_x0_max, :true_iter_max])
        return (merit_all[:, :n_x0_max], opt_all[:, :n_x0_max],
                fsb_all[:, :n_x0_max])

    @staticmethod
    def best_at_all_iter(data_vec: np.ndarray, method: str = "min"):
        """Cumulative best trace (PltOptzResults.py:73-105)."""
        assert data_vec.ndim == 1
        n = data_vec.size
        best = np.full(n, np.nan)
        best[0] = data_vec[0]
        fn = np.fmin if method == "min" else np.fmax
        for i in range(1, n):
            best[i] = fn(best[i - 1], data_vec[i])
        return best

    @classmethod
    def summarize(cls, merit, opt, method: str = "min"):
        """Median-over-starts of the best-so-far traces; the quantity quoted
        in BASELINE.md (min over iterations, median over starts)."""
        n_files, n_x0, n_iter = merit.shape
        best_merit = np.full((n_files, n_x0), np.nan)
        best_opt = np.full((n_files, n_x0), np.nan)
        for i in range(n_files):
            for j in range(n_x0):
                if np.all(np.isnan(merit[i, j])):
                    continue
                best_merit[i, j] = np.nanmin(merit[i, j])
                best_opt[i, j] = np.nanmin(opt[i, j])
        return (np.nanmedian(best_merit, axis=1),
                np.nanmedian(best_opt, axis=1))

    @classmethod
    def plt_conv_nx0(cls, merit_all, labels, out_png: str,
                     ylabel: str = "merit", log_yaxis: bool = True):
        """Convergence plot: median best-so-far per method with start spread
        (PltOptzResults.plt_conv_nx0, PltOptzResults.py:127-197)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(7, 5))
        n_files, n_x0, n_iter = merit_all.shape
        it = np.arange(n_iter)
        for i in range(n_files):
            best = np.stack([cls.best_at_all_iter(merit_all[i, j])
                             for j in range(n_x0)])
            med = np.nanmedian(best, axis=0)
            lo = np.nanmin(best, axis=0)
            hi = np.nanmax(best, axis=0)
            ln = ax.plot(it, med, label=labels[i])[0]
            ax.fill_between(it, lo, hi, alpha=0.15, color=ln.get_color())
        if log_yaxis:
            ax.set_yscale("log")
        ax.set_xlabel("iteration")
        ax.set_ylabel(ylabel)
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_png, dpi=110)
        return fig
