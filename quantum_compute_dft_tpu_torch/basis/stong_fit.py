"""STO-nG expansion generator (a copy of the JAX package's
``basis/stong_fit.py``; numpy and scipy only, no device).

Reproduces the published STO-3G fitting procedure (Hehre, Stewart, Pople,
JCP 51, 2657 (1969)): expand the normalized Slater radial function
R_nl(r) ~ r^{n-1} exp(-r) (zeta = 1) in N normalized Gaussians of angular
momentum l, choosing shared exponents that maximize the total squared
overlap; sp (and spd) shells share one exponent set, fit jointly.

The universal expansions frozen in data.py were generated by this module
and verified against canonical tables for 1s/2sp/3sp/4sp.  Keeping the
generator in-tree makes the basis data reproducible and extensible
(STO-4G/5G, g shells, ...) without external tables.
"""

from __future__ import annotations

from math import factorial, gamma, sqrt

import numpy as np
from scipy.integrate import quad
from scipy.optimize import minimize


def sto_norm(n: int, zeta: float = 1.0) -> float:
    return (2 * zeta) ** (n + 0.5) / sqrt(factorial(2 * n))


def gto_radial_norm(l: int, a: float) -> float:
    k = 2 * l + 2
    integral = gamma((k + 1) / 2.0) / (2.0 * (2.0 * a) ** ((k + 1) / 2.0))
    return 1.0 / sqrt(integral)


def overlap_sto_gto(n: int, l: int, a: float) -> float:
    f = lambda r: r ** (n + l + 1) * np.exp(-r - a * r * r)
    val, _ = quad(f, 0.0, 60.0, limit=200)
    return sto_norm(n) * gto_radial_norm(l, a) * val


def gg_overlap(l: int, a1: float, a2: float) -> float:
    k = 2 * l + 2
    return (
        gto_radial_norm(l, a1)
        * gto_radial_norm(l, a2)
        * gamma((k + 1) / 2.0)
        / (2.0 * (a1 + a2) ** ((k + 1) / 2.0))
    )


def _score(shells, alphas) -> float:
    total = 0.0
    for n, l in shells:
        s = np.array([overlap_sto_gto(n, l, a) for a in alphas])
        S = np.array([[gg_overlap(l, a1, a2) for a2 in alphas] for a1 in alphas])
        total += float(s @ np.linalg.solve(S, s))
    return total


def _coeffs(n, l, alphas):
    s = np.array([overlap_sto_gto(n, l, a) for a in alphas])
    S = np.array([[gg_overlap(l, a1, a2) for a2 in alphas] for a1 in alphas])
    d = np.linalg.solve(S, s)
    return d / sqrt(d @ S @ d)


def fit_shell(shells, x0):
    """shells: [(n, l), ...] sharing exponents. x0: initial exponents.

    Returns (alphas desc-sorted, [coeffs per shell], score-per-shell).
    """
    neg = lambda loga: -_score(shells, np.exp(loga))
    res = minimize(
        neg,
        np.log(np.asarray(x0, float)),
        method="Nelder-Mead",
        options={"xatol": 1e-12, "fatol": 1e-14, "maxiter": 20000, "maxfev": 20000},
    )
    alphas = np.exp(res.x)
    alphas = alphas[np.argsort(-alphas)]
    return alphas, [_coeffs(n, l, alphas) for n, l in shells], -res.fun / len(shells)
