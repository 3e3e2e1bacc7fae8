"""Carry hyperparameters across from the JAX package, as numpy arrays.

The JAX package's ``Hypers`` (fields ``beta``, ``theta``, ``kernel``,
``varK``, ``var_fval``, ``var_fgrad``) and ``HpInfo`` layout are handed over
as plain numpy arrays and a dict of fields, so nothing here imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .types import HpInfo, Hypers

HYPER_FIELDS = Hypers._fields


def hypers_from_numpy(arrays: Mapping[str, Optional[np.ndarray]],
                      device="cuda", dtype=torch.float64) -> Hypers:
    """Hypers on ``device`` from a mapping of field name -> numpy array (or
    None); missing fields are None."""
    def conv(v):
        if v is None:
            return None
        return torch.as_tensor(np.array(v, dtype=np.float64), dtype=dtype,
                               device=device)
    return Hypers(**{f: conv(arrays.get(f)) for f in HYPER_FIELDS})


def hypers_to_numpy(hp: Hypers) -> dict:
    """Inverse of hypers_from_numpy: field name -> float64 numpy array or
    None."""
    return {f: None if getattr(hp, f) is None
            else getattr(hp, f).detach().cpu().numpy().astype(np.float64)
            for f in HYPER_FIELDS}


def hp_info_from_layout(layout: Mapping) -> HpInfo:
    """HpInfo from the fields of the JAX package's HpInfo
    (``dataclasses.asdict`` of it)."""
    return HpInfo(**{k: layout[k] for k in HpInfo.__dataclass_fields__})
