"""CUDA kernels K1 (gradient-enhanced covariance assembly) and K2 (its
fused theta-cotangent), their plain PyTorch versions, the nvcc build and
loading, and a launch counter on each wrapper.

K1 replaces ``gpgradpy_tpu/ops/pallas_assembly.py::_kern_tile_kernel``
(driven by ``kern_grad_pallas``); K2 replaces ``::_kern_vjp_tile_kernel``
(driven by ``kern_grad_pallas_vjp_theta``).  The kernels live in
``csrc/kern_assembly.cu``, whose head note says what bounds them on an H100
(device memory: K1 writes, and K2 reads, (1+d)^2 n1 n2 elements once) and
how their design meets it.

Routing goes by device and by nothing else: a wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches its kernel (on
``torch.cuda.current_stream()``) or raises.  There is no fallback from a
failed launch to the plain version.

The source is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into a shared library with a plain C interface, at first use, into
``build/`` at the repository root (keyed by a hash of the source and the
flags), and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from . import kernels, rtensor

FAMILIES = {"SqExp": 0, "Ma5f2": 1, "RatQu": 2}
_DTYPES = {torch.float32: 0, torch.float64: 1}

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "kern_assembly.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gpgradpy_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_max_dim = {}         # element size -> the kernels' largest d
build_log = ""        # nvcc's output (incl. -Xptxas -v) of the last build
build_seconds = 0.0   # wall time of the last nvcc run in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkern_assembly_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of this source is cached."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kern_grad_launch.argtypes = [ci, ci, vp, vp, vp, vp, vp,
                                         ci, ci, ci, ci, vp]
        lib.kern_grad_launch.restype = ci
        lib.kern_vjp_theta_launch.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp,
                                              vp, ci, ci, ci, ci, vp]
        lib.kern_vjp_theta_launch.restype = ci
        lib.kern_vjp_theta_scratch.argtypes = [ci, ci, ci, ci, ci]
        lib.kern_vjp_theta_scratch.restype = ctypes.c_longlong
        lib.kern_max_dim.argtypes = [ci]
        lib.kern_max_dim.restype = ci
        lib.kern_error_string.argtypes = [ci]
        lib.kern_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.kern_error_string(err).decode()} ({err})")


# ---------------------------------------------------------------------------
# argument normalization shared by the kernels and their plain versions
# ---------------------------------------------------------------------------

def _rows(theta: torch.Tensor, alpha, kernel_type: str):
    """theta (..., d) -> (B, d); alpha (None, float or (...,)) -> (B,) for
    RatQu, None for the families without alpha."""
    d = theta.shape[-1]
    th = theta.reshape(-1, d)
    if kernel_type != "RatQu":
        return th, None
    if alpha is None:
        raise ValueError("RatQu needs alpha")
    a = torch.as_tensor(alpha, dtype=theta.dtype, device=theta.device)
    return th, a.expand(theta.shape[:-1]).reshape(-1).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda_args(kernel_type, x1, x2, theta, extra=()):
    if kernel_type not in FAMILIES:
        raise ValueError(f"unknown kernel family {kernel_type!r}")
    ts = (x1, x2, theta) + tuple(extra)
    if not all(t.is_cuda for t in ts) or len({t.device for t in ts}) != 1:
        raise ValueError("all tensors must lie on one CUDA device")
    if theta.dtype not in _DTYPES or any(t.dtype != theta.dtype for t in ts):
        raise TypeError(f"the kernels take one dtype, float32 or float64; "
                        f"got {[t.dtype for t in ts]}")
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1] \
            or theta.shape[-1] != x1.shape[1]:
        raise ValueError(f"shapes x1 {tuple(x1.shape)}, x2 {tuple(x2.shape)}, "
                         f"theta {tuple(theta.shape)} do not match")
    d = x1.shape[1]
    size = theta.element_size()
    if size not in _max_dim:
        _max_dim[size] = _load().kern_max_dim(size)
    max_d = _max_dim[size]
    if not 1 <= d <= max_d:
        raise ValueError(f"dim {d} outside the kernels' range 1..{max_d}")


# ---------------------------------------------------------------------------
# K1: gradient-enhanced covariance
# ---------------------------------------------------------------------------

def kern_grad_plain(kernel_type: str, x1, x2, theta, alpha=None):
    """Plain PyTorch version of K1: (..., (1+d) n1, (1+d) n2)."""
    return kernels.kern_grad(kernel_type, rtensor.calc_rtensor(x1, x2),
                             theta, alpha)


def kern_grad(kernel_type: str, x1: torch.Tensor, x2: torch.Tensor,
              theta: torch.Tensor, alpha=None) -> torch.Tensor:
    """Gradient-enhanced kernel matrix of x1 (n1, d) against x2 (n2, d) for
    theta (d,) or (B, d): (..., (1+d) n1, (1+d) n2).  CPU tensors take the
    plain version; CUDA tensors launch K1."""
    if not theta.is_cuda:
        return kern_grad_plain(kernel_type, x1, x2, theta, alpha)
    _check_cuda_args(kernel_type, x1, x2, theta)
    lib = _load()
    th, a = _rows(theta, alpha, kernel_type)
    x1c, x2c, th = x1.contiguous(), x2.contiguous(), th.contiguous()
    n1, d = x1c.shape
    n2 = x2c.shape[0]
    B = th.shape[0]
    A = d + 1
    out = torch.empty((B, A * n1, A * n2), dtype=th.dtype, device=th.device)
    err = lib.kern_grad_launch(
        _DTYPES[th.dtype], FAMILIES[kernel_type], x1c.data_ptr(),
        x2c.data_ptr(), th.data_ptr(), _ptr(a), out.data_ptr(),
        B, n1, n2, d, torch.cuda.current_stream(th.device).cuda_stream)
    _check(lib, err, "K1 kern_grad")
    kern_grad.launches += 1
    return out.reshape(*theta.shape[:-1], A * n1, A * n2)


kern_grad.launches = 0


# ---------------------------------------------------------------------------
# K2: theta-cotangent of K1
# ---------------------------------------------------------------------------

def kern_grad_vjp_theta_plain(kernel_type: str, x1, x2, theta, alpha, gbar):
    """Plain PyTorch version of K2: autograd of ``kern_grad_plain`` in
    theta against the cotangent gbar, shape of theta."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        al = alpha.detach() if isinstance(alpha, torch.Tensor) else alpha
        K = kern_grad_plain(kernel_type, x1.detach(), x2.detach(), th, al)
        g, = torch.autograd.grad(K, th, gbar)
    return g


def kern_grad_vjp_theta_regrouped(kernel_type: str, x1, x2, theta, alpha,
                                  gbar):
    """K2's regrouped contraction (the head note of csrc/kern_assembly.cu)
    in plain PyTorch, so the kernel's algebra is checked where it cannot
    run.  With u = theta o R and g_ab = Gbar[a, b] per point pair,

        theta_bar_c = sum R_c^2 m_W + R_c sum_a s_a g_ac + e_c,

    where derivative row 0 gives s_0 = -2 p1 and m_W += p1 g_00 - 2 p2 dot_0,
    a row a > 0 gives s_a = -4 p2 u_a, m_W += 2 p2 u_a g_a0 - 4 p3 u_a dot_a
    - 2 p2 theta_a g_aa and e_a = R_a (2 p1 g_a0 - 4 p2 dot_a) - 2 p1 g_aa,
    and dot_a = sum_{b>=1} u_b g_ab."""
    th, al = _rows(theta, alpha, kernel_type)
    n1, d = x1.shape
    n2 = x2.shape[0]
    A = d + 1
    R = rtensor.calc_rtensor(x1, x2)                           # (d, n1, n2)
    W = kernels.weighted_sqdist(R, th)                         # (B, n1, n2)
    _, p1, p2, p3 = kernels.PHI[kernel_type](W, al)
    p1, p2, p3 = p1[:, None], p2[:, None], p3[:, None]
    G = gbar.reshape(-1, A, n1, A, n2).transpose(2, 3)         # (B, a, b, n1, n2)
    u = th[:, :, None, None] * R                               # (B, d, n1, n2)
    dot = torch.einsum("bcij,bacij->baij", u, G[:, :, 1:])     # dot_a, every a
    g0 = G[:, :, 0]                                            # g_a0
    gaa = torch.diagonal(G[:, 1:, 1:], dim1=1, dim2=2).permute(0, 3, 1, 2)
    mw = (p1[:, 0] * g0[:, 0] - 2.0 * p2[:, 0] * dot[:, 0]
          + (2.0 * p2 * u * g0[:, 1:] - 4.0 * p3 * u * dot[:, 1:]
             - 2.0 * p2 * th[:, :, None, None] * gaa).sum(1))
    e = R * (2.0 * p1 * g0[:, 1:] - 4.0 * p2 * dot[:, 1:]) - 2.0 * p1 * gaa
    s = torch.cat([-2.0 * p1, -4.0 * p2 * u], dim=1)           # (B, A, n1, n2)
    col = torch.einsum("baij,bacij->bcij", s, G[:, :, 1:])
    out = (R * R * mw[:, None] + R * col + e).sum((-2, -1))
    return out.reshape(theta.shape)


def kern_grad_vjp_theta(kernel_type: str, x1: torch.Tensor, x2: torch.Tensor,
                        theta: torch.Tensor, alpha, gbar: torch.Tensor
                        ) -> torch.Tensor:
    """theta_bar[..., c] = sum Gbar[..., :, :] * dK/dtheta_c without
    building dK/dtheta.  gbar has the shape of ``kern_grad``'s output.  CPU
    tensors take the plain version; CUDA tensors launch K2."""
    if not theta.is_cuda:
        return kern_grad_vjp_theta_plain(kernel_type, x1, x2, theta, alpha,
                                         gbar)
    _check_cuda_args(kernel_type, x1, x2, theta, (gbar,))
    lib = _load()
    th, a = _rows(theta, alpha, kernel_type)
    x1c, x2c, th = x1.contiguous(), x2.contiguous(), th.contiguous()
    n1, d = x1c.shape
    n2 = x2c.shape[0]
    B = th.shape[0]
    A = d + 1
    if gbar.shape != (*theta.shape[:-1], A * n1, A * n2):
        raise ValueError(f"gbar shape {tuple(gbar.shape)} does not match "
                         f"the covariance of x1, x2, theta")
    gb = gbar.contiguous()
    partial = torch.empty(
        lib.kern_vjp_theta_scratch(_DTYPES[th.dtype], B, n1, n2, d),
        dtype=th.dtype, device=th.device)
    out = torch.empty((B, d), dtype=th.dtype, device=th.device)
    err = lib.kern_vjp_theta_launch(
        _DTYPES[th.dtype], FAMILIES[kernel_type], x1c.data_ptr(),
        x2c.data_ptr(), th.data_ptr(), _ptr(a), gb.data_ptr(),
        partial.data_ptr(), out.data_ptr(), B, n1, n2, d,
        torch.cuda.current_stream(th.device).cuda_stream)
    _check(lib, err, "K2 kern_grad_vjp_theta")
    kern_grad_vjp_theta.launches += 1
    return out.reshape(theta.shape)


kern_grad_vjp_theta.launches = 0


def reset_launches():
    kern_grad.launches = 0
    kern_grad_vjp_theta.launches = 0
