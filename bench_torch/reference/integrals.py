"""Overlap, kinetic, nuclear-attraction and electron-repulsion integrals
over s and sp shells, by McMurchie-Davidson, in plain torch float64.

Shells are grouped in pairs i >= j of one class ("s"/"sp" x "s"/"sp");
a shell paired with itself keeps only its components a >= b, so that
every pair of AOs a >= b occurs once.  A pair's primitive products carry
their Hermite expansion coefficients E_tuv (Helgaker, Jorgensen, Olsen,
ch. 9), with the contraction coefficients and the Gaussian-product
prefactor folded in.  Then

    (ab|cd) = sum_prims 2 pi^(5/2) / (p q sqrt(p + q))
              sum_tuv E^ab_tuv sum_t'u'v' (-1)^(t'+u'+v') E^cd_t'u'v'
              R_(t+t', u+u', v+v')(pq / (p + q), P - Q)

is evaluated for the pairs of shell pairs in one order and written, with
its mirror, into the pair-packed (npair, npair) matrix G[ab, cd], npair =
nao (nao + 1) / 2, pair index a (a + 1) / 2 + b.  The Boys function comes
from the regularized lower incomplete gamma function.
"""

from __future__ import annotations

from math import exp, lgamma, pi

import numpy as np
import torch

from .basis import Shell

COMPS = {"s": ((0, 0, 0),),
         "sp": ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))}
LMAX = {"s": 0, "sp": 1}


def herm(L: int) -> list[tuple[int, int, int]]:
    """Hermite indices (t, u, v) with t + u + v <= L."""
    return [(t, u, v) for t in range(L + 1) for u in range(L + 1 - t)
            for v in range(L + 1 - t - u)]


def boys(nmax: int, x: torch.Tensor) -> list[torch.Tensor]:
    """[F_0(x), ..., F_nmax(x)]: the highest order from the incomplete
    gamma function, F_n(x) = Gamma(n + 1/2) P(n + 1/2, x) / (2 x^(n+1/2)),
    then down by F_(n-1) = (2 x F_n + exp(-x)) / (2n - 1)."""
    a = nmax + 0.5
    small = x < 1e-8
    xs = torch.where(small, torch.ones_like(x), x)
    gam = exp(lgamma(a))
    top = gam * torch.special.gammainc(torch.full_like(xs, a), xs) / (
        2.0 * xs ** a)
    series = (1.0 / (2 * nmax + 1) - x / (2 * nmax + 3)
              + x * x / (2.0 * (2 * nmax + 5)))
    f = [None] * (nmax + 1)
    f[nmax] = torch.where(small, series, top)
    ex = torch.exp(-x)
    for n in range(nmax, 0, -1):
        f[n - 1] = (2.0 * x * f[n] + ex) / (2 * n - 1)
    return f


def hermite_r(L: int, alpha, xyz, f) -> dict:
    """R_tuv (t + u + v <= L) of the Hermite Coulomb integrals, from
    R^n_000 = (-2 alpha)^n F_n by the recursion in t, then u, then v."""
    x, y, z = xyz
    memo = {}

    def r(t, u, v, n):
        key = (t, u, v, n)
        if key in memo:
            return memo[key]
        if t == u == v == 0:
            val = (-2.0 * alpha) ** n * f[n]
        elif t > 0:
            val = x * r(t - 1, u, v, n + 1)
            if t > 1:
                val = val + (t - 1) * r(t - 2, u, v, n + 1)
        elif u > 0:
            val = y * r(t, u - 1, v, n + 1)
            if u > 1:
                val = val + (u - 1) * r(t, u - 2, v, n + 1)
        else:
            val = z * r(t, u, v - 1, n + 1)
            if v > 1:
                val = val + (v - 1) * r(t, u, v - 2, n + 1)
        memo[key] = val
        return val

    return {h: r(*h, 0) for h in herm(L)}


def _e1d(imax: int, jmax: int, xpa, xpb, oo2p) -> dict:
    """1D Hermite coefficients E^ij_t for i <= imax, j <= jmax (without the
    Gaussian-product prefactor)."""
    e = {(0, 0, 0): torch.ones_like(xpa)}

    def get(i, j, t):
        if t < 0 or t > i + j:
            return None
        return e[(i, j, t)]

    def put(i, j, src, xp):
        for t in range(i + j + 1):
            terms = []
            a, b, c = get(*src, t - 1), get(*src, t), get(*src, t + 1)
            if a is not None:
                terms.append(oo2p * a)
            if b is not None:
                terms.append(xp * b)
            if c is not None:
                terms.append((t + 1) * c)
            e[(i, j, t)] = sum(terms[1:], terms[0])

    for i in range(imax + 1):
        if i > 0:
            put(i, 0, (i - 1, 0), xpa)
        for j in range(1, jmax + 1):
            put(i, j, (i, j - 1), xpb)
    return e


class PairClass:
    """Shell pairs i >= j of one class with their primitive products:
    p (npair, 9), P (npair, 9, 3), the Hermite coefficients
    E (npair, 9, ncomp, nherm) with coefficients and prefactor folded in,
    and the AO indices a >= b of each pair's components (npair, ncomp),
    with their pair-packed index a (a + 1) / 2 + b."""

    def __init__(self, ka, kb, comps, sa: list, sb: list, first_a, first_b,
                 device):
        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                                   device=device)

        self.ka, self.kb = ka, kb
        self.L = LMAX[ka] + LMAX[kb]
        A = t([s.center for s in sa])[:, None, None, :]
        B = t([s.center for s in sb])[:, None, None, :]
        al = t([s.alphas for s in sa])[:, :, None]
        be = t([s.alphas for s in sb])[:, None, :]
        ca = t([s.coeffs for s in sa])          # (np, 3, na)
        cb = t([s.coeffs for s in sb])          # (np, 3, nb)
        p = al + be
        P = (al[..., None] * A + be[..., None] * B) / p[..., None]
        ab2 = ((A - B) ** 2).sum(-1)
        K = torch.exp(-al * be / p * ab2)        # (np, 3, 3)
        oo2p = 0.5 / p
        xpa, xpb = P - A, P - B
        e1 = [_e1d(LMAX[ka], LMAX[kb] + 2, xpa[..., d], xpb[..., d], oo2p)
              for d in range(3)]
        self.p, self.P, self.K, self.e1 = p, P, K, e1
        self.beta = be.expand_as(p)
        # each component's contraction coefficients, (np, 3, 3, ncomp)
        self.cc = torch.stack([ca[:, :, None, x] * cb[:, None, :, y]
                               for x, y in comps], -1)
        hs = herm(self.L)
        self.comps = [(COMPS[ka][x], COMPS[kb][y]) for x, y in comps]
        e = torch.zeros(p.shape + (len(comps), len(hs)), dtype=torch.float64,
                        device=device)
        for ic, (pa, pb) in enumerate(self.comps):
            for ih, h in enumerate(hs):
                val = K.clone()
                for d in range(3):
                    c = e1[d].get((pa[d], pb[d], h[d]))
                    if c is None:
                        val = None
                        break
                    val = val * c
                if val is not None:
                    e[..., ic, ih] = val
        self.E = (e * self.cc[..., None]).reshape(len(sa), 9, len(comps),
                                                  len(hs))
        a = np.asarray(first_a)[:, None] + np.array([x for x, _ in comps])
        b = np.asarray(first_b)[:, None] + np.array([y for _, y in comps])
        self.a = torch.as_tensor(a, device=device)
        self.b = torch.as_tensor(b, device=device)
        self.pairs = self.a * (self.a + 1) // 2 + self.b
        self.pp = p.reshape(len(sa), 9)
        self.PP = P.reshape(len(sa), 9, 3)


def pair_classes(shell_list: list[Shell], device) -> list[PairClass]:
    """The shell pairs i >= j by class; the pairs i == j apart, with their
    components a >= b only."""
    first, n = [], 0
    for s in shell_list:
        first.append(n)
        n += len(COMPS[s.kind])
    out = []
    for ka in ("s", "sp"):
        for kb in ("s", "sp"):
            for same in (False, True) if ka == kb else (False,):
                pairs = [(i, j) for i, si in enumerate(shell_list)
                         for j, sj in enumerate(shell_list[:i + 1])
                         if (si.kind, sj.kind) == (ka, kb)
                         and (i == j) == same]
                if not pairs:
                    continue
                comps = [(x, y) for x in range(len(COMPS[ka]))
                         for y in range(len(COMPS[kb])) if not same or x >= y]
                out.append(PairClass(
                    ka, kb, comps, [shell_list[i] for i, _ in pairs],
                    [shell_list[j] for _, j in pairs],
                    [first[i] for i, _ in pairs],
                    [first[j] for _, j in pairs], device))
    return out


def one_electron(classes, nao: int, coords, charges, device):
    """-> (S, T, V), each (nao, nao) float64."""
    S = torch.zeros(nao * nao, dtype=torch.float64, device=device)
    T = torch.zeros_like(S)
    V = torch.zeros_like(S)
    C = torch.as_tensor(coords, dtype=torch.float64, device=device)
    Z = torch.as_tensor(charges, dtype=torch.float64, device=device)
    for pc in classes:
        p, b = pc.p, pc.beta
        sq = torch.sqrt(pi / p)
        s_out, t_out = [], []
        for pa, pb in pc.comps:
            s1 = [pc.e1[d][(pa[d], pb[d], 0)] * sq for d in range(3)]
            t1 = []
            for d in range(3):
                i, j = pa[d], pb[d]
                v = (-2.0 * b * (2 * j + 1) * s1[d]
                     + 4.0 * b * b * pc.e1[d][(i, j + 2, 0)] * sq)
                if j >= 2:
                    v = v + j * (j - 1) * pc.e1[d][(i, j - 2, 0)] * sq
                t1.append(-0.5 * v)
            s_out.append(s1[0] * s1[1] * s1[2])
            t_out.append(t1[0] * s1[1] * s1[2] + s1[0] * t1[1] * s1[2]
                         + s1[0] * s1[1] * t1[2])
        s_val = (torch.stack(s_out, -1) * pc.K[..., None] * pc.cc).sum((1, 2))
        t_val = (torch.stack(t_out, -1) * pc.K[..., None] * pc.cc).sum((1, 2))
        # nuclear attraction: -sum_C Z_C 2 pi / p sum_tuv E_tuv R_tuv(p, P-C)
        pp, PP = pc.pp[..., None], pc.PP[:, :, None, :]
        pc_d = PP - C[None, None, :, :]
        x = pp * (pc_d ** 2).sum(-1)
        r = hermite_r(pc.L, pp, (pc_d[..., 0], pc_d[..., 1], pc_d[..., 2]),
                      boys(pc.L, x))
        rs = torch.stack([r[h] for h in herm(pc.L)], -1)   # (np, 9, natm, H)
        rz = ((rs * Z[None, None, :, None]).sum(2)
              * (2.0 * pi / pc.pp)[..., None])
        v_val = -torch.einsum("bich,bih->bc", pc.E, rz)
        for rows in ((pc.a * nao + pc.b).reshape(-1),
                     (pc.b * nao + pc.a).reshape(-1)):
            S[rows] = s_val.reshape(-1)
            T[rows] = t_val.reshape(-1)
            V[rows] = v_val.reshape(-1)
    return (S.view(nao, nao), T.view(nao, nao), V.view(nao, nao))


def eri_packed(classes, nao: int, device,
               budget: int = 1 << 27) -> torch.Tensor:
    """G[ab, cd] = (ab|cd) over the AO pairs a >= b and c >= d, pair-packed:
    (npair, npair) float64.  Each class is paired with itself and the
    classes before it, and within a class each bra pair with the ket pairs
    up to the end of its chunk, so every pair of shell pairs is computed
    once and written with its mirror, except that the pairs of one chunk
    meet each other in both orders and are averaged, which keeps G exactly
    symmetric; the bra pairs go in chunks so that about `budget` float64
    elements are live at once."""
    npair = nao * (nao + 1) // 2
    out = torch.empty(npair, npair, dtype=torch.float64, device=device)
    for ib, bra in enumerate(classes):
        for ket in classes[:ib + 1]:
            L = bra.L + ket.L
            hb, hk = herm(bra.L), herm(ket.L)
            hs = herm(L)
            pos = {h: i for i, h in enumerate(hs)}
            idx = torch.tensor([[pos[(a[0] + c[0], a[1] + c[1], a[2] + c[2])]
                                 for c in hk] for a in hb], device=device)
            sign = torch.tensor([(-1.0) ** sum(c) for c in hk],
                                dtype=torch.float64, device=device)
            nk = ket.pp.shape[0]
            live = 81 * nk * (3 * len(hs) + 2 * len(hb) * len(hk) + 16)
            step = max(1, budget // live)
            ek = ket.E * sign
            for s in range(0, bra.pp.shape[0], step):
                e = min(nk, s + step) if ket is bra else nk
                q, Q = ket.pp[None, None, :e], ket.PP[None, None, :e]
                p = bra.pp[s:s + step, :, None, None]
                P = bra.PP[s:s + step, :, None, None, :]
                pq = p + q
                alpha = p * q / pq
                d = P - Q
                x = alpha * (d ** 2).sum(-1)
                r = hermite_r(L, alpha, (d[..., 0], d[..., 1], d[..., 2]),
                              boys(L, x))
                pref = 2.0 * pi ** 2.5 / (p * q * torch.sqrt(pq))
                rs = torch.stack([r[h] for h in hs], -1) * pref[..., None]
                del r
                m = rs[..., idx]                 # (b, 9, k, 9, hb, hk)
                del rs
                y = torch.einsum("bikjhg,kjcg->bikhc", m, ek[:e])
                del m
                g = torch.einsum("biah,bikhc->bakc", bra.E[s:s + step], y)
                del y
                if ket is bra:           # the chunk's pairs with each other
                    blk = g[:, :, s:]
                    g[:, :, s:] = 0.5 * (blk + blk.permute(2, 3, 0, 1))
                lo = s if ket is bra else e  # the ket pairs before the chunk
                rows, cols = bra.pairs[s:s + step], ket.pairs[:e]
                out[rows[:, :, None, None], cols[None, None]] = g
                out[cols[:lo, :, None, None], rows[None, None]] = \
                    g[:, :, :lo].permute(2, 3, 0, 1)
    return out
