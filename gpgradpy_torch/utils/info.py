"""Observability: option dump and telemetry tables (the port's copy of
``gpgradpy_tpu/utils/info.py``, numpy only): the hyperparameter summary,
the theta history and the optimization stats with cond-at-max flags, plus
the option dump, rendered with ``tabulate`` where it is installed and as
tab-separated lines where it is not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

try:
    from tabulate import tabulate
except ImportError:
    def tabulate(rows, headers=(), **kw):
        lines = ["\t".join(str(h) for h in headers)]
        lines += ["\t".join(str(c) for c in r) for r in rows]
        return "\n".join(lines)


def info_surr_options(gp) -> str:
    """Full option dump, one line per config field."""
    cfg = gp.cfg
    lines = ["\nGaussianProcess options"]
    for f in dataclasses.fields(cfg):
        lines.append(f"  {f.name:24s} = {getattr(cfg, f.name)}")
    return "\n".join(lines)


def info_surr_summary(gp, i_max: Optional[int] = None) -> str:
    """Hyperparameter history summary table."""
    h = gp.history
    if h is None:
        return "(no history: call init_optz_surr first)"
    n = i_max if i_max is not None else h.n_optz_max
    headers = ["iter", "ln_lkd", "varK", "kernel", "var_fval", "var_fgrad",
               "beta0", "cond", "nugget"]
    rows = []
    for i in range(n):
        if not np.isfinite(h.hp_theta[i]).any():
            continue
        rows.append([i, f"{h.ln_lkd[i]:.4e}", f"{h.hp_varK[i]:.3e}",
                     f"{h.hp_kernel[i]:.3g}", f"{h.hp_var_fval[i]:.3g}",
                     f"{h.hp_var_fgrad[i]:.3g}", f"{h.hp_beta[i, 0]:.3e}",
                     f"{h.Kcov_cond[i]:.3e}", f"{h.min_nugget[i]:.3e}"])
    return tabulate(rows, headers=headers)


def info_surr_theta(gp, i_max: Optional[int] = None) -> str:
    """Theta history table."""
    h = gp.history
    if h is None:
        return "(no history)"
    n = i_max if i_max is not None else h.n_optz_max
    dim = h.hp_theta.shape[1]
    headers = ["iter"] + [f"theta_{d}" for d in range(dim)]
    rows = [[i] + [f"{v:.4e}" for v in h.hp_theta[i]]
            for i in range(n) if np.isfinite(h.hp_theta[i]).any()]
    return tabulate(rows, headers=headers)


def info_surr_optz(gp, i_max: Optional[int] = None) -> str:
    """Optimization stats table."""
    h = gp.history
    if h is None:
        return "(no history)"
    n = i_max if i_max is not None else h.n_optz_max
    headers = ["iter", "success", "iter_mean", "iter_max", "con_good",
               "n_cho_fail", "n_cond2big", "cond_at_max",
               "t_optz[s]", "t_chofac[s]", "t_hp0[s]"]
    rows = []
    for i in range(n):
        if not np.isfinite(h.hp_theta[i]).any():
            continue
        rows.append([i, f"{h.hp_optz_success[i]:.2f}",
                     f"{h.hp_optz_iter_mean[i]:.1f}",
                     f"{h.hp_optz_iter_max[i]:.0f}",
                     f"{h.hp_optz_con_good[i]:.2f}",
                     f"{h.optz_n_cho_fail[i]:.0f}",
                     f"{h.optz_n_cond2big[i]:.0f}",
                     bool(h.Kcov_cond_at_max[i]),
                     f"{h.time_hp_optz[i]:.3f}",
                     f"{h.time_chofac[i]:.3f}",
                     f"{h.time_pick_hp0[i]:.3f}"])
    return tabulate(rows, headers=headers)


def get_txt_info_surr(gp, i_max: Optional[int] = None) -> str:
    """The option dump and the three tables, as one text."""
    return "\n\n".join([
        info_surr_options(gp),
        "Hyperparameter summary:", info_surr_summary(gp, i_max),
        "Theta history:", info_surr_theta(gp, i_max),
        "Optimization stats:", info_surr_optz(gp, i_max),
    ])
