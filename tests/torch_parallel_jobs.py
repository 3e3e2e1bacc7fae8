"""The port's parallel layer on several ranks: problems and checks that
tests/test_torch_parallel.py runs in one gloo process group per world size
(``parallel.mesh.run_spawned``: spawned processes on the CPU).

This module imports torch, numpy and the port, never JAX: the spawned
ranks import it, and the parent test holds their results to the JAX
package's.  Each rank returns its results as numpy arrays; every result is
the same on every rank (the parent checks that too).
"""

import time

import numpy as np
import torch

FAMILIES = ("SqExp", "Ma5f2", "RatQu")
ALPHA = {"SqExp": None, "Ma5f2": None, "RatQu": 1.7}
ROW_BLOCK = 6            # ragged tiles at every world size (32 / W points)
CHOL_CASES = ((256, 32), (384, 16))


def t64(a):
    return None if a is None else torch.as_tensor(np.array(a),
                                                  dtype=torch.float64)


# ---------------------------------------------------------------------------
# problems (numpy; the same in the parent and in every rank)
# ---------------------------------------------------------------------------

def matvec_problem():
    """tests/test_sharding.py::test_sharded_matvec_matches_dense's points
    and theta (n=32, d=3), a vector, a batch of 3 and an output
    cotangent, all in the point-major layout."""
    rng = np.random.default_rng(0)
    n, dim = 32, 3
    x = rng.uniform(-2, 2, (n, dim))
    theta = rng.uniform(0.3, 1.5, dim)
    N = n * (1 + dim)
    return dict(x=x, theta=theta, v_pm=rng.standard_normal((n, 1 + dim)),
                V_pm=rng.standard_normal((N, 3)),
                G_pm=rng.standard_normal((N, 3)), eta=1e-6)


def spd_geom(n, seed=0, cond=1e4):
    """tests/test_chol_dist.py's SPD matrix."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.geomspace(1.0 / cond, 1.0, n)) @ Q.T


def spd_gram(n, seed=0):
    """tests/test_dense_dist.py's SPD matrix and a cotangent of its
    factor."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n))
    C = np.random.default_rng(1).standard_normal((n, n))
    return B @ B.T / n + np.eye(n), C


def rosen_problem(n_eval, dim, seed=0):
    """tests/test_dense_dist.py::_problem."""
    from gpgradpy_torch.bo.problems import rosenbrock
    x = np.random.default_rng(seed).uniform(-2, 2, (n_eval, dim))
    f, g = rosenbrock(x)
    return x, f, g


def sharding_problem():
    """tests/test_sharding.py::_problem (n=6, d=2) and its 16 starts."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (6, 2))
    x0 = np.random.default_rng(1).uniform(-3, 1, (16, 2))
    return x, np.sum(x ** 2, 1), 2 * x, x0


def iter_problems():
    """tests/test_sharding.py's iterative problems: the MLL (n=40, d=3),
    the noisy MLL (n=24, d=2) and the predict (n=24, d=2), at
    cond_max_target 1e4: (x, f, g, noisy, hyperparameters)."""
    out = {}
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (40, 3))
    out["mll"] = (x, np.sum(x ** 2, 1), 2 * x, False,
                  dict(theta=[0.7, 1.1, 0.4]))
    rng = np.random.default_rng(1)
    x = rng.uniform(-2, 2, (24, 2))
    f = np.sum(x ** 2, 1) + 0.01 * rng.standard_normal(24)
    g = 2 * x + 0.01 * rng.standard_normal((24, 2))
    out["noisy"] = (x, f, g, True, dict(theta=[0.8, 1.2], varK=2.0,
                                        var_fval=1e-3, var_fgrad=2e-3))
    rng = np.random.default_rng(2)
    x = rng.uniform(-2, 2, (24, 2))
    out["predict"] = (x, np.sum(x ** 2, 1), 2 * x, False,
                      dict(theta=[0.8, 1.2]))
    out["xq"] = rng.uniform(-2, 2, (5, 2))
    return out


def gauss_logp(z):
    """The correlated 2-d Gaussian of the inference tests, row by row."""
    prec = np.linalg.inv(np.array([[1.0, 0.8], [0.8, 2.0]]))
    return -0.5 * (prec[0, 0] * z[:, 0] ** 2 + 2 * prec[0, 1] * z[:, 0]
                   * z[:, 1] + prec[1, 1] * z[:, 1] ** 2)


NUTS_KW = dict(n_warmup=30, n_samples=20, max_depth=6)
NUTS_Z0 = np.random.default_rng(4).normal(0.0, 1.0, (4, 2))


def torch_problem(x, f, g, noisy, cond=None, **cfg_kw):
    """cfg, spec and data of the port for one problem."""
    import gpgradpy_torch as tgp
    n, dim = x.shape
    extra = {} if cond is None else dict(cond_max_target=cond, cond_max=cond)
    cfg = tgp.GpConfig(dim=dim, use_grad=True, kernel_type="SqExp",
                       wellcond_mtd="precon", **extra, **cfg_kw)
    z = None if noisy else np.zeros(n)
    zg = None if noisy else np.zeros((n, dim))
    spec = tgp.make_data_spec(dim, True, n, std_fval=z, std_grad=zg)
    data = tgp.GpData(x=t64(x), fval=t64(f), std_fval=t64(z), grad=t64(g),
                      std_grad=t64(zg))
    return cfg, spec, data


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def matvec_checks(mesh):
    """kern_matvec_sharded (one vector, eta P^2 term) and
    kern_matvec_sharded_batch in 3 families, with the theta gradient of
    sum(G * out) through ShardedMatvecFn."""
    from gpgradpy_torch.ops import cuda_assembly
    from gpgradpy_torch.parallel import sharded_matvec as sm
    p = matvec_problem()
    x, th = t64(p["x"]), t64(p["theta"])
    n, dim = p["x"].shape
    K = cuda_assembly.kern_grad_plain("SqExp", x, x, th)
    p2_pm = sm.blocked_to_pointmajor(torch.diagonal(K), n, dim)
    out = {"mv1": sm.kern_matvec_sharded(
        "SqExp", mesh, x, th, None, t64(p["v_pm"]), eta=p["eta"],
        pvec2_pm=p2_pm, row_block=ROW_BLOCK).numpy()}
    for kt in FAMILIES:
        theta = th.clone().requires_grad_(True)
        o = sm.kern_matvec_sharded_batch(kt, mesh, x, theta, ALPHA[kt],
                                         t64(p["V_pm"]), row_block=ROW_BLOCK)
        g, = torch.autograd.grad((t64(p["G_pm"]) * o).sum(), theta)
        out[f"mvb_{kt}"] = o.detach().numpy()
        out[f"mvg_{kt}"] = g.numpy()
    return out


def chol_checks(mesh):
    """cholesky_dist at the JAX test's cases; cholesky_ok_dist's value and
    VJP (a loss sum(L * C))."""
    from gpgradpy_torch.ops import linalg
    from gpgradpy_torch.parallel import chol_dist
    from gpgradpy_torch.parallel.mesh import gather_batch
    out = {}
    for n, block in CHOL_CASES:
        L_loc, logdet = chol_dist.cholesky_dist(mesh, t64(spd_geom(n)), block)
        out[f"chol_{n}_L"] = gather_batch(L_loc, mesh).numpy()
        out[f"chol_{n}_logdet"] = float(logdet)
    A, C = spd_gram(256)
    At = t64(A).requires_grad_(True)
    fac = linalg.cholesky_ok_dist(At, mesh, block=16)
    g, = torch.autograd.grad((fac.L * t64(C)).sum(), At)
    out.update(chol_ok=bool(fac.ok), chol_ok_L=fac.L.detach().numpy(),
               chol_ok_vjp=g.numpy())
    return out


def mll_checks(mesh):
    """neg_mll_and_grad with the mesh on tests/test_dense_dist.py's
    problem (n_eval=32, d=3 -> 128 rows, block 16)."""
    import gpgradpy_torch as tgp
    from gpgradpy_torch.model import conditioning, likelihood
    x, f, g = rosen_problem(32, 3)
    cfg, spec, data = torch_problem(x, f, g, False, dist_chol_block=16)
    eta = conditioning.calc_etaK(cfg, 32)
    v = t64(np.log10(np.full(3, 0.7)))
    val, grad, lkd = likelihood.neg_mll_and_grad(cfg, spec, tgp.HpInfo(dim=3),
                                                 data, v, eta, mesh=mesh)
    return {"mll_val": float(val), "mll_grad": grad.numpy(),
            "mll_ok": bool(lkd.ok)}


def iter_checks(mesh, probes):
    """The iterative MLL and its gradient, the noisy MLL and its gradient,
    and the predict with the mesh, on tests/test_sharding.py's problems
    with the JAX package's probes (point-major)."""
    from gpgradpy_torch import convert
    from gpgradpy_torch.model import conditioning
    from gpgradpy_torch.model import likelihood_iter as tli
    from gpgradpy_torch.model import predict_iter as tpi
    probs = iter_problems()
    kw = dict(max_cg_iters=300, mesh=mesh)
    out = {}
    for name in ("mll", "noisy"):
        x, f, g, noisy, hp = probs[name]
        cfg, spec, data = torch_problem(x, f, g, noisy, cond=1e4)
        eta = conditioning.calc_etaK(cfg, x.shape[0])
        hpt = convert.hypers_from_numpy(hp, device="cpu")
        z = t64(probes[name])
        calc, grad = ((tli.calc_lkd_iterative_noisy,
                       tli.neg_mll_iterative_noisy_and_grad) if noisy else
                      (tli.calc_lkd_iterative, tli.neg_mll_iterative_and_grad))
        lkd = calc(cfg, spec, data, hpt, eta, z, **kw)
        val, gh, _ = grad(cfg, spec, data, hpt, eta, z, **kw)
        out.update({f"{name}_{k}": np.asarray(getattr(lkd, k))
                    for k in ("ln_lkd", "beta", "varK", "cg_iters",
                              "cg_resid")})
        out[f"{name}_val"] = float(val)
        out[f"{name}_grad"] = (gh.theta if noisy else gh).numpy()
        if noisy:
            out[f"{name}_grad_varK"] = gh.varK.numpy()
    x, f, g, noisy, hp = probs["predict"]
    cfg, spec, data = torch_problem(x, f, g, noisy, cond=1e4)
    eta = conditioning.calc_etaK(cfg, x.shape[0])
    hpt = convert.hypers_from_numpy(hp, device="cpu")
    mu, sig, beta, varK, res = tpi.predict_iterative(
        cfg, spec, data, hpt, eta, t64(probs["xq"]), **kw)
    out.update(pred_mu=mu.numpy(), pred_sig=sig.numpy(),
               pred_resid=float(res.residnorm.max()))
    return out


def _facade(x, f, g, solver, **kw):
    from gpgradpy_torch import GaussianProcess
    n, dim = x.shape
    gp = GaussianProcess(dim, True, "SqExp", "precon", device="cpu",
                         solver=solver, **kw)
    gp.init_optz_surr(2)
    gp.set_data(x, f, np.zeros(n), g, np.zeros((n, dim)))
    gp.set_hpara("optz", 0)
    return gp


def iter_fit_problem():
    """A small iterative fit (n_eval=16, d=2, cond 1e3, one start) and its
    probes in the blocked layout."""
    from gpgradpy_torch.ops import iterative
    x, f, g = rosen_problem(16, 2)
    cfg, spec, data = torch_problem(
        x, f, g, False, cond=1e3, solver="iterative", iter_row_block=5,
        iter_max_cg=128, iter_n_probes=8, optz_iter_max=10)
    z = iterative.rademacher(48, 8, 3)
    return cfg, spec, data, z


def iter_fit(mesh=None):
    """fit_map_iterative from one start, with the mesh (probes permuted to
    its point-major layout) or without."""
    import gpgradpy_torch as tgp
    from gpgradpy_torch.fit import iterative_driver
    from gpgradpy_torch.model import conditioning
    from gpgradpy_torch.parallel import sharded_matvec as sm
    cfg, spec, data, z = iter_fit_problem()
    if mesh is not None:
        z = sm.blocked_to_pm_mat(z, 16, 2)
    return iterative_driver.fit_map_iterative(
        cfg, spec, tgp.HpInfo(dim=2), data, conditioning.calc_etaK(cfg, 16),
        x0_override=np.zeros((1, 2)), probes=z.numpy(), mesh=mesh)


def facade_checks(mesh):
    """The facade's dense_dist fit on tests/test_dense_dist.py's problems:
    n_eval=32 (on the grid) and 27 (padded onto it); the iterative fit
    driver with the mesh."""
    fit = iter_fit(mesh)
    out = {"iter_fit_hp": fit.hp_vec, "iter_fit_f": fit.neg_lkd,
           "iter_fit_nval": fit.info["optz_n_val"]}
    xq = np.random.default_rng(9).uniform(-1.5, 1.5, (6, 3))
    for n_eval in (32, 27):
        x, f, g = rosen_problem(n_eval, 3)
        gp = _facade(x, f, g, "dense_dist", dist_chol_block=16,
                     cond_norm="fro")
        out[f"dd{n_eval}_theta"] = gp.hp_vals.theta.numpy()
        out[f"dd{n_eval}_lnL"] = float(gp.history.ln_lkd[0])
        out[f"dd{n_eval}_mu"] = gp.eval_model(xq)[0]
        out[f"dd{n_eval}_n_data_tot"] = gp.spec.n_data_tot
        out[f"dd{n_eval}_mesh"] = gp.optz_infos[0]["dist_mesh_devices"]
    return out


def multistart_checks(mesh):
    """16 L-BFGS starts on tests/test_sharding.py's problem split over the
    ranks (lbfgs_sharded), and the same starts in this one process."""
    import gpgradpy_torch as tgp
    from gpgradpy_torch.fit import lbfgs, multistart
    from gpgradpy_torch.model import conditioning
    from gpgradpy_torch.parallel.mesh import lbfgs_sharded
    x, f, g, x0 = sharding_problem()
    cfg, spec, data = torch_problem(x, f, g, False)
    info = tgp.HpInfo(dim=2)
    obj = multistart.neg_mll_objective(cfg, spec, info, data,
                                       conditioning.calc_etaK(cfg, 6))
    lb, ub = np.full(2, -6.0), np.full(2, 4.0)
    kw = dict(max_iter=50, tol_f=1e-12)
    return {"ms_f": lbfgs_sharded(obj, x0, lb, ub, mesh, **kw).f,
            "ms_f_single": lbfgs.lbfgs_box_multistart(obj, x0, lb, ub,
                                                      **kw).f}


def nuts_checks(mesh):
    """run_nuts_sharded on the Gaussian: 4 chains, pooled adaptation."""
    from gpgradpy_torch.parallel.mesh import run_nuts_sharded
    zs, diag = run_nuts_sharded(gauss_logp, t64(NUTS_Z0), 5, mesh, **NUTS_KW)
    out = {"nuts_z": zs.numpy()}
    out.update({f"nuts_{k}": v.numpy() for k, v in diag.items()})
    return out


def all_checks(mesh, probes):
    """Every check on ``mesh``: {name: numpy result}, with the seconds of
    each group of checks."""
    out = {}
    for name, fn in (("matvec", matvec_checks), ("chol", chol_checks),
                     ("mll", mll_checks),
                     ("iter", lambda m: iter_checks(m, probes)),
                     ("facade", facade_checks),
                     ("multistart", multistart_checks),
                     ("nuts", nuts_checks)):
        t0 = time.perf_counter()
        out.update(fn(mesh))
        out[f"seconds_{name}"] = time.perf_counter() - t0
    return out
