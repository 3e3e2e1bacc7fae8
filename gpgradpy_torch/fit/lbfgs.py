"""Box-constrained L-BFGS over a batch of starts
(counterpart of ``gpgradpy_tpu/fit/lbfgs.py``).

A projected L-BFGS (two-loop recursion, Armijo backtracking along the
projected path with a safeguarded quadratic-interpolation step) with the
JAX package's defaults: history 10, tol_g 1e-8, ls_max 25.  The JAX package
runs one ``lax.while_loop`` per start under ``vmap``; here the loops are
Python loops over a batch of starts, and every start follows exactly the
iterates it would follow alone.  The objective is called once per step of
the loops with the rows of all starts that need a value at that step, so
the device evaluates them as one batch.  The bookkeeping (a few vectors of
length n_hp) stays on the host in numpy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np


class LbfgsResult(NamedTuple):
    x: np.ndarray           # (S, n)
    f: np.ndarray           # (S,)
    g: np.ndarray           # (S, n)
    n_iter: np.ndarray      # (S,)
    converged: np.ndarray   # (S,)
    aux_sum: np.ndarray     # (S,) sum of the objective's aux value over the
                            # start and every accepted iterate


def _two_loop(g, S, Y, rho, hist_len, gamma, m):
    """L-BFGS two-loop recursion over a circular buffer of length m."""
    q = g.copy()
    alphas = np.zeros(m, g.dtype)
    for i in range(m):
        idx = (hist_len - 1 - i) % m
        a = rho[idx] * np.dot(S[idx], q) if i < hist_len else 0.0
        if i < hist_len:
            q = q - a * Y[idx]
        alphas[idx] = a
    r = gamma * q
    for i in range(m):
        idx = (hist_len - min(hist_len, m) + i) % m
        if i < hist_len:
            b = rho[idx] * np.dot(Y[idx], r)
            r = r + (alphas[idx] - b) * S[idx]
    return r


def lbfgs_box_multistart(fun: Callable, x0_all: np.ndarray, lb: np.ndarray,
                         ub: np.ndarray, max_iter: int = 250,
                         history: int = 10, tol_g: float = 1e-8,
                         tol_f: float = 1e-12, ls_max: int = 25
                         ) -> LbfgsResult:
    """Minimize each row's fun subject to lb <= x <= ub.

    ``fun(X)`` takes rows X (b, n) and returns (f (b,), g (b, n), aux (b,))
    as numpy arrays.  A start stops when its projected-gradient infinity
    norm is below tol_g, when an accepted step lowers f by at most
    tol_f * max(1, |f|), when its line search fails, or after max_iter
    iterations."""
    m = history
    X = np.clip(np.array(x0_all), lb, ub)
    dtype = X.dtype
    nS, n = X.shape
    F, G, aux_sum = (np.array(a) for a in fun(X))
    S = np.zeros((nS, m, n), dtype)
    Y = np.zeros((nS, m, n), dtype)
    rho = np.zeros((nS, m), dtype)
    hist_len = np.zeros(nS, int)
    gamma = np.ones(nS, dtype)
    k = np.zeros(nS, int)
    done = np.zeros(nS, bool)

    with np.errstate(all="ignore"):
        while True:
            act = np.nonzero((k < max_iter) & ~done)[0]
            if act.size == 0:
                break
            x, f, g = X[act], F[act], G[act]
            D = np.stack([_two_loop(G[s], S[s], Y[s], rho[s], hist_len[s],
                                    gamma[s], m) for s in act])
            descent = np.sum(D * g, axis=1) > 0.0
            D = np.where(descent[:, None], D, g)

            # backtracking line searches of all active starts, batched
            t = np.ones(act.size, dtype)
            ok = np.zeros(act.size, bool)
            xn, fn, gn = x.copy(), f.copy(), g.copy()
            an = np.zeros(act.size, dtype)
            for _ in range(ls_max):
                srch = np.nonzero(~ok)[0]
                if srch.size == 0:
                    break
                x_try = np.clip(x[srch] - t[srch, None] * D[srch], lb, ub)
                f_try, g_try, a_try = fun(x_try)
                slope = -np.sum(g[srch] * (x[srch] - x_try), axis=1)
                ok_new = (f_try <= f[srch] + 1e-4 * slope) & np.isfinite(f_try)
                acc = srch[ok_new]
                xn[acc], fn[acc], gn[acc] = x_try[ok_new], f_try[ok_new], g_try[ok_new]
                an[acc] = a_try[ok_new]
                ok[srch] = ok_new
                # quadratic-interpolation trial, safeguarded to [0.1 t, 0.5 t]
                ts = t[srch]
                denom = 2.0 * (f_try - f[srch] - slope)
                t_quad = -slope * ts / np.where(denom > 0.0, denom, np.inf)
                t[srch] = np.clip(np.where(np.isfinite(t_quad), t_quad, 0.5 * ts),
                                  0.1 * ts, 0.5 * ts)

            s_vec = xn - x
            y_vec = gn - g
            sy = np.sum(s_vec * y_vec, axis=1)
            update = ok & (sy > 1e-16)
            for q in np.nonzero(update)[0]:
                s = act[q]
                slot = hist_len[s] % m
                S[s, slot] = s_vec[q]
                Y[s, slot] = y_vec[q]
                rho[s, slot] = 1.0 / max(sy[q], 1e-300)
                hist_len[s] += 1
                gamma[s] = sy[q] / max(np.dot(y_vec[q], y_vec[q]), 1e-300)

            pg = xn - np.clip(xn - gn, lb, ub)
            conv_g = np.max(np.abs(pg), axis=1) < tol_g
            conv_f = np.abs(f - fn) <= tol_f * np.maximum(1.0, np.abs(fn))
            done[act] = conv_g | (ok & conv_f) | ~ok
            k[act] += 1
            X[act], F[act], G[act] = xn, fn, gn
            aux_sum[act] += np.where(ok, an, 0.0)

    return LbfgsResult(x=X, f=F, g=G, n_iter=k, converged=done,
                       aux_sum=aux_sum)
