"""Acquisition functions with analytic gradients (counterpart of
``gpgradpy_tpu/bo/acquisition.py``), on tensors: built from the
surrogate's (mu, sigma, dmu/dx, dsigma/dx), so the acquisition optimizer
is gradient-based and batched over query points."""

from __future__ import annotations

import math

import torch


def ucb(mu, sig, dmudx=None, dsigdx=None, beta: float = 2.0):
    """Lower-confidence bound for minimization: acq = mu - beta sig.
    Returns (acq, dacq/dx or None)."""
    acq = mu - beta * sig
    if dmudx is None:
        return acq, None
    return acq, dmudx - beta * dsigdx


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def expected_improvement(mu, sig, fval_best, dmudx=None, dsigdx=None,
                         sig_min: float = 1e-12):
    """Negative expected improvement (to minimize):
    -EI = -[(f* - mu) Phi(z) + sig phi(z)], z = (f* - mu)/sig,
    with d(-EI)/dx = Phi(z) dmu/dx - phi(z) dsig/dx."""
    sig_safe = torch.clamp_min(sig, sig_min)
    z = (fval_best - mu) / sig_safe
    cdf, pdf = torch.special.ndtr(z), _norm_pdf(z)
    acq = -((fval_best - mu) * cdf + sig_safe * pdf)
    if dmudx is None:
        return acq, None
    return acq, cdf[..., None] * dmudx - pdf[..., None] * dsigdx
