"""Pairwise-difference tensors and data-vector packing
(counterpart of ``gpgradpy_tpu/ops/rtensor.py``)."""

from __future__ import annotations

import torch


def calc_rtensor(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """R[d, i, j] = x1[i, d] - x2[j, d]."""
    return (x1[:, None, :] - x2[None, :, :]).permute(2, 0, 1)


def calc_dist_min(x: torch.Tensor) -> torch.Tensor:
    """Minimum pairwise Euclidean distance."""
    n = x.shape[0]
    d2 = torch.sum((x[:, None, :] - x[None, :, :]) ** 2, dim=-1)
    d2 = d2 + torch.diag(torch.full((n,), float("inf"), dtype=x.dtype,
                                    device=x.device))
    return torch.sqrt(torch.min(d2))


def make_data_vec(fval: torch.Tensor, fgrad=None) -> torch.Tensor:
    """Stack [f; vec(grad f)] with the gradient flattened grouped by
    coordinate (column-major), the row layout of the covariance."""
    fval = torch.atleast_1d(fval)
    if fgrad is None:
        return fval
    return torch.cat([fval, fgrad.T.reshape(-1)])

