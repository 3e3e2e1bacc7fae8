"""2-D marginal-likelihood contour debug plot (counterpart of
``gpgradpy_tpu/utils/lkd_contour.py``).

``lkd_grid`` evaluates the negative MLL over an n_grid x n_grid grid of two
hp-vector components as ONE batch through the start scan of the fit
(``fit/multistart.scan_neg_mll``): n_grid^2 hyperparameter rows, so on the
card one K1 launch at B = n_grid^2 assembles every covariance.  The other
components stay at a base point (the current fit by default).
``plt_debug_lkd`` draws it and imports matplotlib only when called.
"""

from __future__ import annotations

import numpy as np

from ..fit import multistart
from ..types import hypers_to_hp_vec


def lkd_grid(gp, dims=(0, 1), n_grid=10, base_hp_vec=None, bounds=None,
             i_optz=0):
    """Negative MLL on an n_grid x n_grid grid (optimization space) over
    the hp-vector components ``dims``; returns (vec_i, vec_j, lkd_val) with
    lkd_val[i, j] at (vec_j[j], vec_i[i]) (meshgrid 'xy' layout).  Rows
    whose value is not finite are inf.  ``i_optz`` selects that round's
    history-dependent hp bounds."""
    cfg, spec, info = gp.cfg, gp.spec, gp.hp_info_optz_lkd
    if bounds is None:
        b = multistart.get_hp_bounds(cfg, info, gp.history, i_optz)
        lb, ub = np.asarray(b.box_lb), np.asarray(b.box_ub)
    else:
        lb, ub = map(np.asarray, bounds)
    if base_hp_vec is None:
        if getattr(gp, "hp_vals", None) is not None:
            base_hp_vec = hypers_to_hp_vec(info, gp.hp_vals).cpu().numpy()
        else:
            base_hp_vec = 0.5 * (lb + ub)
    base_hp_vec = np.asarray(base_hp_vec, float)

    i, j = dims
    vec_i = np.linspace(lb[i], ub[i], n_grid)
    vec_j = np.linspace(lb[j], ub[j], n_grid)
    Xi, Xj = np.meshgrid(vec_i, vec_j)          # (n_grid, n_grid)

    grid = np.tile(base_hp_vec, (n_grid * n_grid, 1))
    grid[:, i] = Xi.ravel()
    grid[:, j] = Xj.ravel()

    vals, _ = multistart.scan_neg_mll(cfg, spec, info, gp.data,
                                      float(gp._etaK), grid)
    return vec_i, vec_j, np.asarray(vals, float).reshape(n_grid, n_grid)


def plt_debug_lkd(gp, i_optz=0, dims=(0, 1), n_grid=10, hp_x0=None,
                  hp_optz=None, base_hp_vec=None, path=None, show=False):
    """Contour plot of the (min-max normalized) negative MLL over two
    hyperparameters, with multistart points and the optimum overlaid.

    ``hp_x0``: (n_start, n_hp) starts in optimization (log10) space;
    ``hp_optz``: (n_hp,) the fitted optimum.  Saves to ``path`` if given;
    returns the grid's values."""
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vec_i, vec_j, lkd_val = lkd_grid(gp, dims, n_grid, base_hp_vec,
                                     i_optz=i_optz)
    finite = np.isfinite(lkd_val)
    if finite.any():
        lo, hi = np.nanmin(lkd_val[finite]), np.nanmax(lkd_val[finite])
        norm = (lkd_val - lo) / max(hi - lo, 1e-300)
    else:
        # the whole grid failed (e.g. every Cholesky): still draw the plot
        norm = np.zeros_like(lkd_val)

    Xi, Xj = np.meshgrid(10.0 ** vec_i, 10.0 ** vec_j)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.set_title(f"i optz = {i_optz}")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(rf"$\gamma_{{{dims[0] + 1}}}$")
    ax.set_ylabel(rf"$\gamma_{{{dims[1] + 1}}}$", rotation=0)
    ax.grid(True)
    cs = ax.contourf(Xi, Xj, norm, cmap="viridis")
    if hp_x0 is not None:
        hp_x0 = np.atleast_2d(np.asarray(hp_x0, float))
        ax.plot(10.0 ** hp_x0[:, dims[0]], 10.0 ** hp_x0[:, dims[1]], "rs")
    if hp_optz is not None:
        hp_optz = np.asarray(hp_optz, float)
        ax.plot(10.0 ** hp_optz[dims[0]], 10.0 ** hp_optz[dims[1]], "m*",
                markersize=12)
    fig.colorbar(cs)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    if show:
        plt.show()
    plt.close(fig)
    return lkd_val
