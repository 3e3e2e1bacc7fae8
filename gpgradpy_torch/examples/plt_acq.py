"""Acquisition-function demo on the 1-D test problem: surrogate + UCB and
EI curves (counterpart of ``examples/plt_acq.py``), with the port's
``bo.acquisition``.

    python -m gpgradpy_torch.examples.plt_acq [--device cpu]
"""

import numpy as np
import torch

from gpgradpy_torch import GaussianProcess
from gpgradpy_torch.bo import acquisition

from .plt_surr_1d import calc_grad, calc_obj


def compute(use_grad=True, kernel_type="SqExp", wellcond_mtd="precon",
            device="cuda"):
    """Fit the 4-point GP, then mu, sig, UCB and -EI on a 500-point grid;
    returns a dict of numpy arrays."""
    xmin, xmax = 2.5, 7.5
    x_eval = np.array([3.5, 4.5, 5.5, 6.5])[:, None]
    n_eval = x_eval.shape[0]
    x_exa = np.linspace(xmin, xmax, 500)[:, None]
    fval = calc_obj(x_eval)
    grad = calc_grad(x_eval)

    gp = GaussianProcess(1, use_grad, kernel_type, wellcond_mtd,
                         device=device)
    gp.init_optz_surr(2)
    gp.set_data(x_eval, fval, np.zeros(n_eval),
                grad if use_grad else None,
                np.zeros((n_eval, 1)) if use_grad else None)
    gp.set_hpara("optz", 0)

    mu, sig = gp.eval_model(x_exa)[:2]
    mu_t, sig_t = torch.as_tensor(mu), torch.as_tensor(sig)
    acq_ucb, _ = acquisition.ucb(mu_t, sig_t, beta=2.0)
    acq_ei, _ = acquisition.expected_improvement(mu_t, sig_t,
                                                 float(np.min(fval)))
    return dict(x_eval=x_eval, fval=fval, x_exa=x_exa, mu=mu, sig=sig,
                ucb=acq_ucb.numpy(), ei=acq_ei.numpy())


def plot(res, out_png):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .surr_plt import SurrPlt

    fig, axes = plt.subplots(2, 1, figsize=(7, 7), sharex=True,
                             height_ratios=[2, 1])
    splt = SurrPlt()
    splt.plot_surr(axes[0], res["x_exa"], calc_obj(res["x_exa"]),
                   res["x_eval"], res["fval"], res["mu"], res["sig"])
    splt.plot_acq(axes[1], res["x_exa"], [res["ucb"], res["ei"]],
                  labels=[r"UCB ($\mu - 2\sigma$)", r"$-$EI"])
    axes[1].set_xlabel("x")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(use_grad=True, kernel_type="SqExp", wellcond_mtd="precon",
         out_png="plt_acq.png", device="cuda"):
    plot(compute(use_grad, kernel_type, wellcond_mtd, device), out_png)
    print(f"saved {out_png}")


if __name__ == "__main__":
    from ._cli import device_arg
    main(device=device_arg(__doc__))
