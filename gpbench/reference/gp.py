"""Plain reference of the gradient-enhanced GP that the benchmark judges
gpgradpy_torch against.

Written from the equations of Marchildon & Zingg (J. Sci. Comput. 2023,
arXiv:2307.05855) in plain PyTorch, float64 by default: no kernels, no
batching, no import of the program.  Everything is recomputed from raw
inputs (points, values, gradients) and from the answers the program gave
(hyperparameters, scalings, proposals), which are only judged.

Covariance: squared exponential k(x, y) = exp(-sum_a theta_a (x_a - y_a)^2),
gradient-enhanced, rows ordered [values; d/dx_1 of every point; ...;
d/dx_d of every point].  Noise-free data, constant mean (poly_ord_0):

    beta  = (V^T K^-1 V)^-1 V^T K^-1 y,   r = y - V beta
    varK  = r^T K^-1 r / N
    -ln L = (N ln varK + ln det K) / 2

Conditioning, two methods of the paper:
- precon: P = diag(K)^(1/2), M = P^-1 K P^-1 + eta I, K_eta = P M P, with
  eta from the bound on the preconditioned rows (paper, section 4);
- rescale_origin: the data rescaled so that the points' least distance is
  vreq(n, d) (paper, section 5), M = K + eta I with the rescaled bound.
"""

from __future__ import annotations

import math

import torch


# ---------------------------------------------------------------------------
# conditioning policies (closed forms of the paper)
# ---------------------------------------------------------------------------

def eta_precon(n: int, d: int, cond_max: float) -> float:
    """Nugget that bounds cond(M) by cond_max for the preconditioned SqExp
    matrix: 1 + the largest off-diagonal row sum, over cond_max - 1."""
    if n == 1:
        return n / (cond_max - 1.0)
    s = math.sqrt(1.0 + 4.0 * d)
    row = 0.5 * (n - 1) * (1.0 + s) * math.exp(-(1.0 + 2.0 * d - s) / (4.0 * d))
    return (1.0 + row) / (cond_max - 1.0)


def vreq_rescale(n: int, d: int) -> float:
    """Least point distance the rescaling method asks for."""
    if n == 1:
        return 1.0
    dist_star = 2.0 * math.sqrt(d)
    root = math.sqrt(4.0 + 2.0 * math.e ** 2
                     * math.log((n - 1) * (1.0 + dist_star) / 2.0))
    return min((2.0 + root) / math.e, dist_star)


def eta_rescale(n: int, d: int, cond_max: float) -> float:
    """Nugget that bounds cond(K + eta I) by cond_max once the least point
    distance is vreq(n, d)."""
    if n == 1:
        return n / (cond_max - 1.0)
    v_frac = 2.0 * math.sqrt(d) / vreq_rescale(n, d)
    eig_max = 1.0 + (n - 1) * v_frac * math.exp(1.0 / v_frac - 1.0)
    return eig_max / (cond_max - 1.0)


def min_distance(x):
    """Least distance between two of the points x (n, d), from the
    coordinate differences (no Gram-matrix shortcut)."""
    r = x[:, None, :] - x[None, :, :]
    dist = torch.sqrt((r * r).sum(-1))
    dist.fill_diagonal_(float("inf"))
    return float(dist.min())


def rescale_initial_scale(x):
    """The rescaling method's first frame: one scale for every coordinate,
    so that the points shifted to the last one lie at least vreq(n, d)
    apart."""
    n, d = x.shape
    s = vreq_rescale(n, d) / min_distance(x - x[-1])
    return torch.full((d,), s, dtype=x.dtype, device=x.device)


def rescale_step(x, xvec_scale, theta):
    """One step of the rescaling method's fixed-point loop from a fit's
    theta in the frame xvec_scale: the coordinates stretched by
    sqrt(theta / theta*) (theta* the geometric mean), then scaled so that
    the points lie at least vreq(n, d) apart.  Returns (the new scaling
    vector, the theta that it predicts in the new frame (theta* over the
    correction squared, every coordinate), the spread of log10 theta)."""
    n, d = x.shape
    lt = torch.log10(theta)
    theta_star = 10.0 ** lt.mean()
    stretch = torch.sqrt(theta / theta_star)
    xs = (x - x[-1]) * xvec_scale * stretch
    correction = vreq_rescale(n, d) / min_distance(xs)
    spread = float(((lt - lt.mean()) ** 2).sum())
    return (xvec_scale * stretch * correction,
            torch.full_like(theta, float(theta_star) / correction ** 2),
            spread)


def rescale_loop_frames(x, inner_thetas):
    """The frames of the rescaling method's loop, given the theta that each
    inner fit found: every inner fit runs in the first frame; the loop
    then keeps the step whose theta had the least spread.  Returns (the
    inner fits' scaling vector, the final scaling vector, the final
    theta)."""
    xvec0 = rescale_initial_scale(x)
    steps = [rescale_step(x, xvec0, th) for th in inner_thetas]
    best = min(range(len(steps)), key=lambda i: steps[i][2])
    return xvec0, steps[best][0], steps[best][1]


def rescaled_frame(x, f, g, xvec_scale):
    """The rescaling method's frame for the scaling vector xvec_scale: x
    shifted to the last point and scaled per coordinate, f shifted to the
    last value and scaled to a range of 100, gradients by the chain rule."""
    x_shift = x[-1]
    obj_scale = 100.0 / max(1e-20, float(f.max() - f.min()))
    xs = (x - x_shift) * xvec_scale
    fs = (f - f[-1]) * obj_scale
    gs = g * obj_scale / xvec_scale
    return xs, fs, gs


# ---------------------------------------------------------------------------
# covariance and likelihood
# ---------------------------------------------------------------------------

def covariance(x, theta, xq=None):
    """Gradient-enhanced SqExp covariance.  Without xq: the (N, N) matrix of
    the training data (N = n (1 + d)).  With xq (m, d): the (N, m)
    covariance of the training data with the values at xq."""
    n, d = x.shape
    if xq is None:
        r = x[:, None, :] - x[None, :, :]                       # (n, n, d)
        phi = torch.exp(-(theta * r * r).sum(-1))
        tr = 2.0 * theta * r                                     # (n, n, d)
        K = x.new_empty((1 + d) * n, (1 + d) * n)
        K[:n, :n] = phi
        for a in range(d):
            ra = slice((1 + a) * n, (2 + a) * n)
            # cov(df/dx_a(x_i), f(x_j)) = -2 theta_a r_a phi
            K[ra, :n] = -tr[..., a] * phi
            K[:n, ra] = tr[..., a] * phi
            for b in range(d):
                rb = slice((1 + b) * n, (2 + b) * n)
                blk = -tr[..., a] * tr[..., b] * phi
                if a == b:
                    blk = blk + 2.0 * theta[a] * phi
                K[ra, rb] = blk
        return K
    r = x[:, None, :] - xq[None, :, :]                           # (n, m, d)
    phi = torch.exp(-(theta * r * r).sum(-1))
    parts = [phi] + [-2.0 * theta[a] * r[..., a] * phi for a in range(d)]
    return torch.cat(parts, 0)


class Model:
    """The regularized covariance of one data set at one theta, factorized,
    with the closed-form beta and varK and -ln L.  Differentiable in
    log10_theta (a leaf the caller may mark requires_grad)."""

    def __init__(self, x, f, g, log10_theta, method: str, cond_max: float):
        n, d = x.shape
        self.x, self.n, self.d = x, n, d
        self.theta = 10.0 ** log10_theta
        K = covariance(x, self.theta)
        N = K.shape[0]
        self.N = N
        y = torch.cat([f, g.T.reshape(-1)])
        V = torch.zeros(N, 1, dtype=x.dtype, device=x.device)
        V[:n] = 1.0
        if method == "precon":
            p = torch.sqrt(torch.diagonal(K))
            eta = eta_precon(n, d, cond_max)
            M = K / (p[:, None] * p[None, :])
        elif method == "rescale_origin":
            p = torch.ones(N, dtype=x.dtype, device=x.device)
            eta = eta_rescale(n, d, cond_max)
            M = K
        else:
            raise ValueError(f"unknown method {method}")
        M = M + eta * torch.eye(N, dtype=x.dtype, device=x.device)
        self.M, self.p = M, p
        self.L = torch.linalg.cholesky(M)
        self.logdet = 2.0 * torch.log(torch.diagonal(self.L)).sum() \
            + 2.0 * torch.log(p).sum()
        invK_V = self.solve(V)
        A = V.T @ invK_V
        self.beta = torch.linalg.solve(A, invK_V.T @ y[:, None])[:, 0]
        r = y - V @ self.beta
        self.alpha = self.solve(r[:, None])[:, 0]
        self.varK = (r * self.alpha).sum() / N
        self.nll = 0.5 * (N * torch.log(self.varK) + self.logdet)

    def solve(self, B):
        """K_eta^-1 B = P^-1 M^-1 P^-1 B for B (N, k)."""
        P = self.p[:, None]
        return torch.cholesky_solve(B / P, self.L) / P

    def cond_fro(self):
        """Frobenius condition number of M: |M|_F |M^-1|_F."""
        inv = torch.cholesky_inverse(self.L)
        return torch.linalg.norm(self.M) * torch.linalg.norm(inv)

    def predict(self, xq):
        """(mu, sig, dmu/dx, dsig/dx) at the query points xq (m, d) of the
        data's frame; the x-derivatives by autograd."""
        xq = xq.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            k = covariance(self.x, self.theta.detach(), xq)      # (N, m)
            mu = self.beta.detach()[0] + k.T @ self.alpha.detach()
            s2 = 1.0 - (k * self.solve(k)).sum(0)
            pos = s2 > 0
            # sqrt has no derivative at 0: the gradient there is taken as 0
            sig = torch.where(pos, torch.sqrt(torch.where(pos, s2, 1.0)),
                              0.0) * torch.sqrt(self.varK.detach())
            dmu, = torch.autograd.grad(mu.sum(), xq, retain_graph=True)
            dsig, = torch.autograd.grad(sig.sum(), xq)
        return mu.detach(), sig.detach(), dmu, dsig


def nll_and_grad(x, f, g, log10_theta, method, cond_max):
    """(-ln L, its gradient in log10 theta, Model) at log10_theta."""
    lt = log10_theta.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        m = Model(x, f, g, lt, method, cond_max)
        grad, = torch.autograd.grad(m.nll, lt)
    return m.nll.detach(), grad, m


def projected_grad(grad, log10_theta, lb, ub):
    """The gradient with the components that push out of the box [lb, ub]
    at an active bound set to 0."""
    at_lb = (log10_theta <= lb) & (grad > 0)
    at_ub = (log10_theta >= ub) & (grad < 0)
    return torch.where(at_lb | at_ub, torch.zeros_like(grad), grad)


def neg_expected_improvement(mu, sig, fbest, sig_min=1e-12):
    """-EI for minimization: -[(f* - mu) Phi(z) + sig phi(z)],
    z = (f* - mu) / sig."""
    s = torch.clamp_min(sig, sig_min)
    z = (fbest - mu) / s
    cdf = 0.5 * torch.erfc(-z / math.sqrt(2.0))
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return -((fbest - mu) * cdf + s * pdf)


def kkt_residual(x, f, g, log10_theta, method, cond_max_target, cond_max,
                 lb, ub):
    """(-ln L, KKT residual, cond_fro(M)) at log10_theta of min -ln L
    subject to cond_fro(M) <= cond_max and the box [lb, ub]: the largest
    entry of the projected grad(-ln L) + lam grad(cond) with the
    least-squares lam >= 0 where the constraint is active (cond within 10%
    of cond_max), else of the projected grad(-ln L).  Whether the
    constraint holds is the caller's to judge from the cond returned."""
    lt = log10_theta.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        m = Model(x, f, g, lt, method, cond_max_target)
        g_nll, = torch.autograd.grad(m.nll, lt, retain_graph=True)
        cond = m.cond_fro()
        g_c, = torch.autograd.grad(cond, lt)
    r = g_nll
    if float(cond.detach()) >= 0.9 * cond_max:
        lam = max(0.0, -float(g_nll @ g_c) / max(float(g_c @ g_c), 1e-300))
        r = g_nll + lam * g_c
    r = projected_grad(r, lt.detach(), lb, ub)
    return float(m.nll.detach()), float(r.abs().max()), float(cond.detach())
