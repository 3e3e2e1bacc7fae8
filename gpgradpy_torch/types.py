"""Data, hyperparameter and static-spec containers.

Counterpart of ``gpgradpy_tpu/types.py``.  ``GpData`` and ``Hypers`` hold
torch tensors; ``DataSpec`` and ``HpInfo`` are the same frozen dataclasses
(static shape and flag information, computed on the host).

Hyperparameter fields may carry a leading batch dimension: ``theta`` is
``(d,)`` or ``(B, d)`` and the scalar fields ``()`` or ``(B,)``.  The model
functions evaluate every row of a batch independently, which is how the
port writes out what the JAX package does with ``vmap``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class GpData(NamedTuple):
    """Training data on one device."""
    x: torch.Tensor                       # (n_eval, dim)
    fval: torch.Tensor                    # (n_eval,)
    std_fval: Optional[torch.Tensor]      # (n_eval,) or None
    grad: Optional[torch.Tensor]          # (n_grad, dim) or None
    std_grad: Optional[torch.Tensor]      # (n_grad, dim) or None


class Hypers(NamedTuple):
    """Hyperparameter values; fields may be None (see the module note on
    the optional batch dimension)."""
    beta: Optional[torch.Tensor] = None       # mean-function coefficients
    theta: Optional[torch.Tensor] = None      # inverse length-scales
    kernel: Optional[torch.Tensor] = None     # RatQu alpha
    varK: Optional[torch.Tensor] = None       # kernel variance
    var_fval: Optional[torch.Tensor] = None   # noise variance on f
    var_fgrad: Optional[torch.Tensor] = None  # noise variance on grad f


@dataclass(frozen=True)
class DataSpec:
    """Static description of a dataset.

    ``n_pad_eval`` > 0 means the arrays carry that many padding points after
    the real ones; they are masked out of the model (identity rows and
    columns in the covariance, zero mean-basis rows, zero data entries,
    count corrections in the MLL).
    """
    dim: int
    n_eval: int
    n_grad: int
    use_grad: bool
    known_eps_fval: bool
    known_eps_fgrad: bool
    b_fval_zero: bool
    b_fgrad_zero: bool
    idx_grad: Optional[Tuple[int, ...]] = None
    n_pad_eval: int = 0

    @property
    def n_eval_tot(self) -> int:
        return self.n_eval + self.n_pad_eval

    @property
    def n_data(self) -> int:
        """Real data count (MLL normalization)."""
        return self.n_eval + self.n_grad * self.dim

    @property
    def n_data_tot(self) -> int:
        """Padded matrix size."""
        return self.n_eval_tot + self.n_grad * self.dim

    @property
    def b_has_noisy_data(self) -> bool:
        return not (self.b_fval_zero and self.b_fgrad_zero)

    @property
    def b_optz_var_fval(self) -> bool:
        return not self.known_eps_fval

    @property
    def b_optz_var_fgrad(self) -> bool:
        return self.use_grad and not self.known_eps_fgrad

    @property
    def idx_grad_arr(self) -> Optional[np.ndarray]:
        """Indices of the points with gradient rows, or None for all."""
        if self.idx_grad is None:
            return None
        if self.n_pad_eval == 0 and len(self.idx_grad) == self.n_eval:
            return None
        return np.asarray(self.idx_grad, dtype=np.int64)

    def pad_mask(self) -> Optional[np.ndarray]:
        """(n_data_tot,) float mask: 1 for real entries, 0 for padding;
        None when there is no padding."""
        if self.n_pad_eval == 0:
            return None
        m = np.ones(self.n_data_tot)
        m[self.n_eval:self.n_eval_tot] = 0.0
        return m


def make_data_spec(dim: int, use_grad: bool, n_eval: int,
                   std_fval=None, std_grad=None,
                   bvec_use_grad=None, n_pad_eval: int = 0) -> DataSpec:
    """Host-side construction of the static spec from raw numpy inputs."""
    if use_grad:
        if bvec_use_grad is None:
            idx_grad = tuple(range(n_eval))
        else:
            idx_grad = tuple(int(i) for i in np.nonzero(np.asarray(bvec_use_grad))[0])
        n_grad = len(idx_grad)
    else:
        idx_grad = None
        n_grad = 0

    known_eps_fval = std_fval is not None and not np.any(np.isnan(std_fval))
    known_eps_fgrad = (use_grad and std_grad is not None
                       and not np.any(np.isnan(std_grad)))

    b_fval_zero = bool(known_eps_fval and np.max(std_fval) < 1e-10)
    if not use_grad:
        b_fgrad_zero = True
    elif known_eps_fgrad:
        b_fgrad_zero = bool(np.max(std_grad) < 1e-10)
    else:
        b_fgrad_zero = False

    return DataSpec(dim=dim, n_eval=n_eval, n_grad=n_grad, use_grad=use_grad,
                    known_eps_fval=known_eps_fval,
                    known_eps_fgrad=known_eps_fgrad,
                    b_fval_zero=b_fval_zero, b_fgrad_zero=b_fgrad_zero,
                    idx_grad=idx_grad, n_pad_eval=n_pad_eval)


@dataclass(frozen=True)
class HpInfo:
    """Layout of the flat hyperparameter optimization vector:
    [theta | kernel | varK | var_fval | var_fgrad], each entry in log10 space
    where its bit in ``bvec_log`` is set."""
    dim: int
    has_theta: bool = True
    has_kernel: bool = False
    has_varK: bool = False
    has_var_fval: bool = False
    has_var_fgrad: bool = False
    log_theta: bool = True
    log_kernel: bool = True
    log_var: bool = True

    @property
    def n_hp(self) -> int:
        return (self.has_theta * self.dim + self.has_kernel + self.has_varK
                + self.has_var_fval + self.has_var_fgrad)

    def _offset(self, field: str) -> int:
        off = self.has_theta * self.dim
        for name in ("kernel", "varK", "var_fval", "var_fgrad"):
            if name == field:
                return off
            off += getattr(self, f"has_{name}")
        raise KeyError(field)

    @property
    def idx_kernel(self):
        return self._offset("kernel") if self.has_kernel else None

    @property
    def idx_varK(self):
        return self._offset("varK") if self.has_varK else None

    @property
    def idx_var_fval(self):
        return self._offset("var_fval") if self.has_var_fval else None

    @property
    def idx_var_fgrad(self):
        return self._offset("var_fgrad") if self.has_var_fgrad else None

    @property
    def bvec_log(self) -> np.ndarray:
        bits = []
        if self.has_theta:
            bits += [self.log_theta] * self.dim
        if self.has_kernel:
            bits += [self.log_kernel]
        for has in (self.has_varK, self.has_var_fval, self.has_var_fgrad):
            if has:
                bits += [self.log_var]
        return np.asarray(bits, dtype=bool)


def hp_vec_to_hypers(info: HpInfo, hp_vec: torch.Tensor) -> Hypers:
    """Undo the log10 parameterization of ``hp_vec`` (``(n_hp,)`` or
    ``(B, n_hp)``) and scatter it into Hypers.  Differentiable, so autograd
    of a downstream scalar includes the log10 chain rule."""
    bvec = torch.as_tensor(info.bvec_log, device=hp_vec.device)
    vals = torch.where(bvec, torch.pow(10.0, hp_vec), hp_vec)
    theta = vals[..., : info.dim] if info.has_theta else None
    kernel = vals[..., info.idx_kernel] if info.has_kernel else None
    varK = vals[..., info.idx_varK] if info.has_varK else None
    var_fval = vals[..., info.idx_var_fval] if info.has_var_fval else None
    var_fgrad = vals[..., info.idx_var_fgrad] if info.has_var_fgrad else None
    return Hypers(beta=None, theta=theta, kernel=kernel, varK=varK,
                  var_fval=var_fval, var_fgrad=var_fgrad)


def hypers_to_hp_vec(info: HpInfo, hp: Hypers) -> torch.Tensor:
    """Inverse of hp_vec_to_hypers (values -> optimization space)."""
    parts = []
    if info.has_theta:
        parts.append(hp.theta)
    for name in ("kernel", "varK", "var_fval", "var_fgrad"):
        if getattr(info, f"has_{name}"):
            parts.append(getattr(hp, name)[..., None])
    vec = torch.cat([torch.as_tensor(p) for p in parts], dim=-1)
    bvec = torch.as_tensor(info.bvec_log, device=vec.device)
    return torch.where(bvec, torch.log10(vec), vec)


def cast_float_tree(tree, dt: torch.dtype):
    """Cast every floating-point tensor of ``tree`` (a tensor, None, or a
    NamedTuple such as GpData / Hypers, nested) to ``dt``; other leaves
    pass through.  The polish and refined-predict paths promote the f32
    data and hyperparameters of the main fit with it (types.py:253 of the
    JAX package)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dt) if tree.is_floating_point() else tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_float_tree(v, dt) for v in tree))
    return tree
