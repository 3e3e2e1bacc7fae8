"""Plotting helpers: surrogate mean +- n sigma band and acquisition curves
(counterpart of ``examples/surr_plt.py``).  They draw on the axes they are
given, so this module imports no matplotlib itself."""

import numpy as np


class SurrPlt:
    fs_label = 14
    fs_ticks = 12
    fs_legend = 12

    def plot_surr(self, ax, x_exa, f_exa, x_eval, f_eval, mu, sig,
                  n_sig: int = 2, label_true="True fn", label_mu=r"$\mu$"):
        """True function, data points, surrogate mean and +-n sigma band."""
        x_exa = np.asarray(x_exa).ravel()
        ax.plot(x_exa, f_exa, "k-", label=label_true)
        ax.plot(np.asarray(x_eval).ravel(), f_eval, "ko", ms=6,
                label="Data")
        ax.plot(x_exa, mu, "b-", label=label_mu)
        ax.fill_between(x_exa, mu - n_sig * sig, mu + n_sig * sig,
                        color="b", alpha=0.2,
                        label=rf"$\mu \pm {n_sig}\sigma$")
        ax.tick_params(labelsize=self.fs_ticks)
        ax.legend(fontsize=self.fs_legend)

    def plot_acq(self, ax, x_exa, acq_vals, labels=None):
        """Acquisition curves."""
        x_exa = np.asarray(x_exa).ravel()
        acq_vals = np.atleast_2d(acq_vals)
        for i, acq in enumerate(acq_vals):
            lbl = labels[i] if labels else f"acq {i}"
            ax.plot(x_exa, acq, label=lbl)
        ax.tick_params(labelsize=self.fs_ticks)
        ax.legend(fontsize=self.fs_legend)
