"""Conditioning policies: nugget bounds and rescaling requirements.

Host-side closed forms from the two papers (counterpart of
``gpgradpy_tpu/model/conditioning.py``).  They depend only on static
quantities (n_eval, dim, kernel type, target condition number), so they are
computed once per dataset and passed into the covariance assembly as
constants.
"""

from __future__ import annotations

import math

from ..config import GpConfig


def calc_nugget_kbase(n_eval: int, cond_max: float) -> float:
    """eta >= n / (cond_max - 1) guarantees cond(Kbase + eta I) <= cond_max
    (GpWellCond.py:109-114)."""
    return n_eval / (cond_max - 1.0)


def calc_mtd_rescale_origin_vreq(n_eval: int, dim: int) -> float:
    """Required minimum inter-point distance for the rescaling method
    (GpWellCond.py:26-40)."""
    if n_eval == 1:
        return 1.0
    dist_star = 2.0 * math.sqrt(dim)
    sqrt_term = math.sqrt(
        4.0 + 2.0 * math.e ** 2 * math.log((n_eval - 1) * (1.0 + dist_star) / 2.0))
    vmin_req = (2.0 + sqrt_term) / math.e
    return min(vmin_req, dist_star)


def calc_nugget_kfull_vreq(n_eval: int, dim: int, cond_max: float,
                           vmin: float = None) -> float:
    """Nugget bound for the rescaled gradient-enhanced matrix
    (GpWellCond.py:78-99)."""
    if vmin is None:
        vmin = calc_mtd_rescale_origin_vreq(n_eval, dim)
    if n_eval == 1:
        return n_eval / (cond_max - 1.0)
    assert vmin >= math.sqrt(2.0), f"requires vmin = {vmin} >= sqrt(2)"
    v_frac = 2.0 * math.sqrt(dim) / vmin
    u_eigmax = 1.0 + (n_eval - 1) * v_frac * math.exp(1.0 / v_frac - 1.0)
    return u_eigmax / (cond_max - 1.0)


def calc_nugget(cfg: GpConfig, n_eval: int):
    """(eta_Kbase, eta_Kgrad) for the configured conditioning policy
    (GpWellCond.py:116-154)."""
    if cfg.cond_eta_set_mtd == "dflt_eta":
        return cfg.cond_eta_dflt, cfg.cond_eta_dflt

    cond_max = cfg.cond_max_target
    dim = cfg.dim
    eta_kbase = calc_nugget_kbase(n_eval, cond_max)

    if not cfg.use_grad:
        return eta_kbase, float("nan")

    if n_eval == 1:
        eta_kgrad = eta_kbase
    elif cfg.wellcond_mtd == "precon":
        # kernel-specific upper bounds on the off-diagonal row sums of the
        # preconditioned correlation matrix (GpWellCond.py:126-138)
        if cfg.kernel_type in ("SqExp", "RatQu"):
            ub = (0.5 * (n_eval - 1) * (1.0 + math.sqrt(1.0 + 4 * dim))
                  * math.exp(-(1.0 + 2 * dim - math.sqrt(1.0 + 4 * dim)) / (4 * dim)))
        elif cfg.kernel_type == "Ma5f2":
            a = ((math.sqrt(3 * dim) - 1 + math.sqrt(15 * dim + 2 * math.sqrt(3 * dim) + 1))
                 / (2 * (3 * dim + math.sqrt(3 * dim))))
            ub = ((n_eval - 1)
                  * (1 + (dim + math.sqrt(3 * dim)) * a
                     + dim * (1 + math.sqrt(3 * dim)) * a ** 2)
                  * math.exp(-math.sqrt(3 * dim) * a))
        else:
            raise ValueError(f"Unknown kernel {cfg.kernel_type}")
        eta_kgrad = (1.0 + ub) / (cond_max - 1.0)
    elif "rescale" in cfg.wellcond_mtd:
        eta_kgrad = calc_nugget_kfull_vreq(n_eval, dim, cond_max)
    else:
        if cfg.cond_eta_set_mtd == "Kbase_eta":
            eta_kgrad = eta_kbase
        elif cfg.cond_eta_set_mtd == "Kbase_eta_w_dim":
            eta_kgrad = eta_kbase * (dim + 1)
        else:
            raise ValueError(
                f"Unknown method for cond_eta_set_mtd = {cfg.cond_eta_set_mtd}")

    return eta_kbase, eta_kgrad


def calc_etaK(cfg: GpConfig, n_eval: int) -> float:
    """The constant nugget used by the covariance assembly."""
    eta_kbase, eta_kgrad = calc_nugget(cfg, n_eval)
    return eta_kgrad if cfg.use_grad else eta_kbase
