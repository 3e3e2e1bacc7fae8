"""gpgradpy_torch: the gradient-enhanced Gaussian process in PyTorch, with
hand-written CUDA kernels for the covariance assembly on NVIDIA Hopper.

The port of ``gpgradpy_tpu`` (JAX/Pallas), module for module.  It imports
torch, numpy and scipy, and nothing of JAX or of the JAX package.
"""

from .api import GaussianProcess  # noqa: F401
from .config import GpConfig  # noqa: F401
from .types import (  # noqa: F401
    DataSpec, GpData, HpInfo, Hypers, hp_vec_to_hypers, hypers_to_hp_vec,
    make_data_spec,
)

__version__ = "0.1.0"
