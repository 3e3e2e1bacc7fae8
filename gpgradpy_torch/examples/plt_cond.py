"""Condition-number study: cond(K) and the scaled marginal log-likelihood
as 2-D contour maps over (gamma_1, gamma_2) for each conditioning method,
on Rosenbrock data (counterpart of ``examples/plt_cond.py``).  Each
method's n_gamma x n_gamma grid is one batched likelihood call with the
condition number (B = n_gamma^2 hyperparameter rows).

    python -m gpgradpy_torch.examples.plt_cond [--device cpu]
"""

import numpy as np
import torch

from gpgradpy_torch import GpConfig, GpData, Hypers, make_data_spec
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.fit import lhs
from gpgradpy_torch.model import conditioning, likelihood
from gpgradpy_torch.ops import kernels


def compute(kernel_type="SqExp", wellcond_mtds=("base", "precon"),
            n_eval=10, n_gamma=30, device="cuda"):
    """Returns (gamma_vec, {method: (log10 cond map, ln lkd map)}), the
    maps (n_gamma, n_gamma) with NaN where the Cholesky failed."""
    dim = 2
    x_eval = lhs.lhs_sample(n_eval, np.full(dim, -1.5), np.full(dim, 1.5),
                            seed=2)
    fval, grad = rosenbrock(x_eval)

    gamma_vec = np.logspace(-2, 2, n_gamma)
    G1, G2 = np.meshgrid(gamma_vec, gamma_vec)
    th_grid = np.stack([kernels.gamma2theta(kernel_type, G1.ravel()),
                        kernels.gamma2theta(kernel_type, G2.ravel())], axis=1)

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    maps = {}
    for mtd in wellcond_mtds:
        cfg = GpConfig(dim=dim, use_grad=True, kernel_type=kernel_type,
                       wellcond_mtd=mtd)
        spec = make_data_spec(dim, True, n_eval, std_fval=np.zeros(n_eval),
                              std_grad=np.zeros((n_eval, dim)))
        data = GpData(x=t(x_eval), fval=t(fval), std_fval=t(np.zeros(n_eval)),
                      grad=t(grad), std_grad=t(np.zeros((n_eval, dim))))
        eta = conditioning.calc_etaK(cfg, n_eval)
        with torch.no_grad():
            lkd = likelihood.calc_lkd(cfg, spec, data,
                                      Hypers(theta=t(th_grid)), eta,
                                      calc_cond=True)
        ok = lkd.ok.cpu().numpy()
        lkd_v = np.where(ok, lkd.ln_lkd.cpu().numpy(), np.nan)
        maps[mtd] = (np.log10(lkd.cond.cpu().numpy()).reshape(n_gamma, n_gamma),
                     lkd_v.reshape(n_gamma, n_gamma))
    return gamma_vec, maps


def plot(gamma_vec, maps, out_png):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    G1, G2 = np.meshgrid(gamma_vec, gamma_vec)
    fig, axes = plt.subplots(len(maps), 2, figsize=(11, 4.5 * len(maps)))
    axes = np.atleast_2d(axes)
    for row, (mtd, (cond_map, lkd_map)) in enumerate(maps.items()):
        for col, (mp, title) in enumerate(
                [(cond_map, r"$\log_{10}$ cond"),
                 (lkd_map, "scaled ln lkd")]):
            ax = axes[row, col]
            if col == 1 and np.any(np.isfinite(mp)):
                lo, hi = np.nanmin(mp), np.nanmax(mp)
                mp = (mp - lo) / max(hi - lo, 1e-30)
            cs = ax.contourf(G1, G2, mp, cmap="viridis")
            ax.set_xscale("log")
            ax.set_yscale("log")
            ax.set_xlabel(r"$\gamma_1$")
            ax.set_ylabel(r"$\gamma_2$")
            ax.set_title(f"{mtd}: {title}")
            fig.colorbar(cs, ax=ax)
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(kernel_type="SqExp", wellcond_mtds=("base", "precon"),
         n_eval=10, n_gamma=30, out_png="plt_cond.png", device="cuda"):
    plot(*compute(kernel_type, wellcond_mtds, n_eval, n_gamma, device),
         out_png)
    print(f"saved {out_png}")


if __name__ == "__main__":
    from ._cli import device_arg
    main(device=device_arg(__doc__))
