"""McMurchie-Davidson machinery in torch: Hermite expansion coefficients E
and the Hermite Coulomb tensor R, built by recursion unrolled in Python
with static angular-momentum bounds.

Port of ``quantum_compute_dft_tpu/integrals/mcmurchie.py``.  Every entry
is an elementwise expression of its tensor arguments, so the same code
serves one primitive pair or a whole batch (the callers vmap over pairs).
"""

from __future__ import annotations

import torch


def e_tables(imax: int, jmax: int, a, b, ab):
    """Hermite expansion coefficients for one dimension.

    Returns E with shape (imax+1, jmax+1, imax+jmax+1) + a.shape: E[i, j, t]
    is the coefficient of the Hermite Gaussian H_t in the product of
    cartesian powers x_A^i x_B^j; a, b are exponents, ab = A - B (this
    dimension).
    """
    p = a + b
    mu = a * b / p
    x_pa = -b / p * ab   # P - A = -(b/p)(A-B)
    x_pb = a / p * ab    # P - B = +(a/p)(A-B)
    inv2p = 0.5 / p

    zero = torch.zeros_like(p)
    memo = {(0, 0, 0): torch.exp(-mu * ab * ab)}

    def E(i, j, t):
        if t < 0 or t > i + j or i < 0 or j < 0:
            return zero
        key = (i, j, t)
        if key in memo:
            return memo[key]
        if i > 0:
            val = (
                inv2p * E(i - 1, j, t - 1)
                + x_pa * E(i - 1, j, t)
                + (t + 1) * E(i - 1, j, t + 1)
            )
        else:
            val = (
                inv2p * E(i, j - 1, t - 1)
                + x_pb * E(i, j - 1, t)
                + (t + 1) * E(i, j - 1, t + 1)
            )
        memo[key] = val
        return val

    out = torch.stack([
        torch.stack([
            torch.stack([E(i, j, t) for t in range(imax + jmax + 1)])
            for j in range(jmax + 1)
        ])
        for i in range(imax + 1)
    ])
    memo.clear()   # E refers to itself: see r_tensor
    return out


def hermite_combos(lmax_total: int):
    """All (t, u, v) with t+u+v <= lmax_total, in a fixed static order."""
    combos = []
    for t in range(lmax_total + 1):
        for u in range(lmax_total + 1 - t):
            for v in range(lmax_total + 1 - t - u):
                combos.append((t, u, v))
    return combos


def r_tensor(lmax_total: int, p, pc, boys_table):
    """Hermite Coulomb integrals R^0_{tuv}(p, PC) for t+u+v <= lmax_total.

    pc: (3,) + p.shape; boys_table: F_n(p |PC|^2) for n = 0..lmax_total,
    shape (lmax_total+1,) + p.shape.  Returns dict {(t,u,v): value}.
    """
    zero = torch.zeros_like(p)
    memo = {}

    def R(n, t, u, v):
        if t < 0 or u < 0 or v < 0:
            return zero
        key = (n, t, u, v)
        if key in memo:
            return memo[key]
        if t == u == v == 0:
            val = (-2.0 * p) ** n * boys_table[n]
        else:
            # recurse along the first nonzero index; the (k-1) R(k-2) term
            # vanishes for k == 1 and is skipped (same values, fewer ops)
            k, ax = (t, 0) if t > 0 else (u, 1) if u > 0 else (v, 2)
            lo = [t, u, v]
            lo[ax] -= 1
            val = pc[ax] * R(n + 1, *lo)
            if k > 1:
                lo[ax] -= 1
                val = (k - 1) * R(n + 1, *lo) + val
        memo[key] = val
        return val

    out = {tuv: R(0, *tuv) for tuv in hermite_combos(lmax_total)}
    # R's closure refers to R itself: the cycle would keep every memoized
    # intermediate alive until the cyclic collector runs (on the card, GBs
    # per quartet tile); drop them now
    memo.clear()
    return out
