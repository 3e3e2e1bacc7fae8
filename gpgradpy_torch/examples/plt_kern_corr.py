"""Kernel correlation plots: k(r), k'(r), -k''(r) for the three kernel
families (counterpart of ``examples/plt_kern_corr.py``), by autograd of
``ops.kernels.scalar_kernel`` (``torch.func.grad``, vectorized with
``torch.func.vmap``).

    python -m gpgradpy_torch.examples.plt_kern_corr [--device cpu]
"""

import numpy as np
import torch
from torch.func import grad, vmap

from gpgradpy_torch.ops import kernels

CASES = (("SqExp", None), ("Ma5f2", None), ("RatQu", 2.0))


def compute(device="cuda"):
    """r on [-4, 4] and, per family, (k, k', k'') as numpy arrays."""
    r = np.linspace(-4, 4, 401)
    rt = torch.as_tensor(r, dtype=torch.float64, device=device)
    theta = torch.ones(1, dtype=torch.float64, device=device)
    zero = torch.zeros(1, dtype=torch.float64, device=device)
    out = {}
    for ktype, alpha in CASES:
        def k(ri):
            return kernels.scalar_kernel(ktype, ri[None], zero, theta, alpha)

        out[ktype] = tuple(vmap(fn)(rt).cpu().numpy()
                           for fn in (k, grad(k), grad(grad(k))))
    return r, out


def plot(r, corr, out_png):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    for ktype, (kv, dk, d2k) in corr.items():
        axes[0].plot(r, kv, label=ktype)
        axes[1].plot(r, dk, label=ktype)
        axes[2].plot(r, -d2k, label=ktype)
    for ax, title in zip(axes, ["$k(r)$", "$k'(r)$", "$-k''(r)$"]):
        ax.set_title(title)
        ax.set_xlabel("r")
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(out_png="plt_kern_corr.png", device="cuda"):
    plot(*compute(device), out_png)
    print(f"saved {out_png}")


if __name__ == "__main__":
    from ._cli import device_arg
    main(device=device_arg(__doc__))
