"""Nugget study: condition number against gamma for several nugget
policies on a 2-D Rosenbrock dataset of LHS points (counterpart of
``examples/plt_nugget_1d.py``); each policy's sweep is one batched
assembly (B = n_gamma hyperparameter rows).

    python -m gpgradpy_torch.examples.plt_nugget_1d [--device cpu]
"""

import numpy as np
import torch

from gpgradpy_torch import GpConfig, GpData, Hypers, make_data_spec
from gpgradpy_torch.bo.problems import rosenbrock
from gpgradpy_torch.fit import lhs
from gpgradpy_torch.model import assembly, conditioning
from gpgradpy_torch.ops import kernels

CASES = (
    ("base, eta = n/(kappa-1)", "base", {}),
    ("base, eta = 1e-8", "base", {"cond_eta_set_mtd": "dflt_eta",
                                  "cond_eta_dflt": 1e-8}),
    ("precon", "precon", {}),
)


def compute(kernel_type="SqExp", n_eval=10, n_gamma=60, device="cuda"):
    """Returns (gamma_vec, {label: cond (n_gamma,)})."""
    dim = 2
    x_eval = lhs.lhs_sample(n_eval, np.full(dim, -1.5), np.full(dim, 1.5),
                            seed=2)
    fval, grad = rosenbrock(x_eval)
    spec = make_data_spec(dim, True, n_eval, std_fval=np.zeros(n_eval),
                          std_grad=np.zeros((n_eval, dim)))

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    data = GpData(x=t(x_eval), fval=t(fval), std_fval=t(np.zeros(n_eval)),
                  grad=t(grad), std_grad=t(np.zeros((n_eval, dim))))
    gamma_vec = np.logspace(-2, 2, n_gamma)
    theta = np.repeat(kernels.gamma2theta(kernel_type, gamma_vec)[:, None],
                      dim, axis=1)
    conds = {}
    for label, mtd, extra in CASES:
        cfg = GpConfig(dim=dim, use_grad=True, kernel_type=kernel_type,
                       wellcond_mtd=mtd, **extra)
        eta = conditioning.calc_etaK(cfg, n_eval)
        with torch.no_grad():
            ops = assembly.assemble_keta(cfg, spec, data,
                                         Hypers(theta=t(theta)), eta)
            conds[label] = assembly.calc_cond(ops).cpu().numpy()
    return gamma_vec, conds


def plot(gamma_vec, conds, out_png):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for label, c in conds.items():
        ax.loglog(gamma_vec, c, label=label)
    ax.axhline(1e10, color="k", ls="--", lw=1, label=r"$\kappa_{\max}$")
    ax.set_xlabel(r"$\gamma$")
    ax.set_ylabel("cond")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(kernel_type="SqExp", n_eval=10, n_gamma=60,
         out_png="plt_nugget_1d.png", device="cuda"):
    plot(*compute(kernel_type, n_eval, n_gamma, device), out_png)
    print(f"saved {out_png}")


if __name__ == "__main__":
    from ._cli import device_arg
    main(device=device_arg(__doc__))
