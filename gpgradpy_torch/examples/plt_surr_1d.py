"""1-D surrogate demo: fit sin(x) + sin(10x/3), sweep the likelihood over
gamma, and plot the posterior fits at the local MLL maxima (counterpart of
``examples/plt_surr_1d.py``).  The sweep is one batched likelihood call
over every gamma (B = 200 hyperparameter rows).

    python -m gpgradpy_torch.examples.plt_surr_1d [--device cpu]
"""

import numpy as np
import torch
from scipy.signal import argrelextrema

from gpgradpy_torch import GaussianProcess, GpConfig, GpData, Hypers, make_data_spec
from gpgradpy_torch.model import conditioning, likelihood
from gpgradpy_torch.ops import kernels


def calc_obj(x):
    x1 = np.asarray(x)[:, 0]
    return np.sin(x1) + np.sin(10 * x1 / 3.0)


def calc_grad(x):
    x1 = np.asarray(x)[:, 0]
    return (np.cos(x1) + (10.0 / 3.0) * np.cos(10 * x1 / 3.0))[:, None]


def compute(use_grad=True, kernel_type="SqExp", wellcond_mtd="precon",
            device="cuda"):
    """The likelihood sweep, its local maxima and the surrogate at each;
    returns a dict of numpy arrays."""
    xmin, xmax = 2.5, 7.5
    n_eval, n_exa = 6, 400
    x_eval = np.linspace(xmin, xmax, n_eval + 2)[1:-1, None]
    x_exa = np.linspace(xmin, xmax, n_exa)[:, None]
    fval = calc_obj(x_eval)
    grad = calc_grad(x_eval)

    cfg = GpConfig(dim=1, use_grad=use_grad, kernel_type=kernel_type,
                   wellcond_mtd=wellcond_mtd)
    spec = make_data_spec(1, use_grad, n_eval, std_fval=np.zeros(n_eval),
                          std_grad=np.zeros((n_eval, 1)))

    def t(v):
        return torch.as_tensor(v, dtype=torch.float64, device=device)

    data = GpData(x=t(x_eval), fval=t(fval), std_fval=t(np.zeros(n_eval)),
                  grad=t(grad) if use_grad else None,
                  std_grad=t(np.zeros((n_eval, 1))) if use_grad else None)
    eta = conditioning.calc_etaK(cfg, n_eval)

    gamma_vec = np.logspace(-2, 1.5, 200)
    theta_vec = kernels.gamma2theta(kernel_type, gamma_vec)
    with torch.no_grad():
        lkd_vals = likelihood.calc_lkd(cfg, spec, data,
                                       Hypers(theta=t(theta_vec[:, None])),
                                       eta).ln_lkd.cpu().numpy()

    idx_max = argrelextrema(lkd_vals, np.greater)[0]
    if len(idx_max) == 0:
        idx_max = np.array([int(np.argmax(lkd_vals))])

    mu_all, sig_all = [], []
    for idx in idx_max:
        gp = GaussianProcess(1, use_grad, kernel_type, wellcond_mtd,
                             device=device)
        gp.set_data(x_eval, fval, np.zeros(n_eval),
                    grad if use_grad else None,
                    np.zeros((n_eval, 1)) if use_grad else None)
        gp.set_hpara("set", 0, hp_vals=gp.make_hp_class(
            theta=np.atleast_1d(theta_vec[idx])))
        mu, sig = gp.eval_model(x_exa)[:2]
        mu_all.append(mu)
        sig_all.append(sig)
    return dict(x_eval=x_eval, fval=fval, x_exa=x_exa, gamma_vec=gamma_vec,
                lkd_vals=lkd_vals, idx_max=idx_max, mu=np.array(mu_all),
                sig=np.array(sig_all))


def plot(res, out_png):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .surr_plt import SurrPlt

    gamma_vec, lkd_vals, idx_max = (res["gamma_vec"], res["lkd_vals"],
                                    res["idx_max"])
    n_fits = len(idx_max)
    fig, axes = plt.subplots(1, n_fits + 1, figsize=(5 * (n_fits + 1), 4))
    axes = np.atleast_1d(axes)
    axes[0].semilogx(gamma_vec, lkd_vals, "b-")
    axes[0].semilogx(gamma_vec[idx_max], lkd_vals[idx_max], "r*", ms=12)
    axes[0].set_xlabel(r"$\gamma$")
    axes[0].set_ylabel("marginal log-likelihood")
    splt = SurrPlt()
    f_exa = calc_obj(res["x_exa"])
    for k, idx in enumerate(idx_max):
        splt.plot_surr(axes[k + 1], res["x_exa"], f_exa, res["x_eval"],
                       res["fval"], res["mu"][k], res["sig"][k])
        axes[k + 1].set_title(rf"$\gamma = {gamma_vec[idx]:.3f}$")
    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def main(use_grad=True, kernel_type="SqExp", wellcond_mtd="precon",
         out_png="plt_surr_1d.png", device="cuda"):
    res = compute(use_grad, kernel_type, wellcond_mtd, device)
    print("local MLL maxima at gamma =", res["gamma_vec"][res["idx_max"]])
    plot(res, out_png)
    print(f"saved {out_png}")
    return res["gamma_vec"], res["lkd_vals"], res["idx_max"]


if __name__ == "__main__":
    from ._cli import device_arg
    main(device=device_arg(__doc__))
