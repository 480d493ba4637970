"""Two-electron repulsion integrals (ij|kl) via McMurchie-Davidson, torch f64.

Port of ``quantum_compute_dft_tpu/integrals/two_electron.py``, same
two-stage formulation:

  1. *Pair stage* -- for every unique cartesian AO pair and every primitive
     pair, the combined Hermite coefficients Etilde_{tuv} = Ex[t] Ey[u] Ez[v]
     plus (p, P, coefficient).
  2. *Quartet stage* -- a uniform kernel over (bra pair, ket pair)
     contracting Etilde_bra x Etilde_ket against the Hermite Coulomb
     tensor R(alpha, P-Q), evaluated on dense (block x block) tiles of the
     pair list with ``torch.func.vmap``.

Schwarz screening (|(ij|kl)| <= Q_ij Q_kl) compacts the pair list before
the quartet stage.
"""

from __future__ import annotations

from math import pi

import numpy as np
import torch
from torch.func import vmap

from quantum_compute_dft_tpu_torch.basis.basis_set import NPRIM, BasisSet
from quantum_compute_dft_tpu_torch.integrals.boys import boys_fast as boys
from quantum_compute_dft_tpu_torch.integrals.mcmurchie import (
    e_tables,
    hermite_combos,
    r_tensor,
)


def _pair_stage(la: int, lb: int | None = None):
    """Hermite pair quantities for (la, lb) cartesian functions."""
    if lb is None:
        lb = la
    combos = hermite_combos(la + lb)

    def pair(pa, pb, A, B, a, b):
        """One primitive pair -> (p, P, Etilde[nc])."""
        p = a + b
        P = (a * A + b * B) / p
        ab3 = A - B
        Es = [e_tables(la, lb, a, b, ab3[d]) for d in range(3)]
        ex = [Es[d][pa[d], pb[d], :] for d in range(3)]
        et = torch.stack([ex[0][t] * ex[1][u] * ex[2][v]
                          for (t, u, v) in combos])
        return p, P, et

    return pair


def _quartet_kernel(l_bra: int, device, l_ket: int | None = None):
    """Contraction kernel over Hermite pair data with bra combos bounded by
    total angular momentum l_bra and ket combos by l_ket.

    The returned function (the JAX package's ``_block_runner``) takes a
    BLOCK of bra pairs and a block of ket pairs and returns the (nbra,
    nket) quartet values, with the pair axes
    written out as leading batch dimensions.  (The JAX package vmaps a
    one-quartet kernel twice; under torch.func.vmap every one of the
    ~500 Hermite-recursion ops of that kernel pays a batch-dimension copy,
    measured 5x slower on CPU than the broadcast form below.)"""
    if l_ket is None:
        l_ket = l_bra
    combos_b = hermite_combos(l_bra)
    combos_k = hermite_combos(l_ket)
    f64 = torch.float64
    parity = torch.tensor([(-1.0) ** (t + u + v) for (t, u, v) in combos_k],
                          dtype=f64, device=device)
    sum_combos = hermite_combos(l_bra + l_ket)
    sum_index = {tuv: i for i, tuv in enumerate(sum_combos)}
    # static 0/1 selection tensor: SEL[s, a, b] = 1 iff combo_a + combo_b
    # lands on sum-combo s
    sel = np.zeros((len(sum_combos), len(combos_b), len(combos_k)))
    for a, (t1, u1, v1) in enumerate(combos_b):
        for b, (t2, u2, v2) in enumerate(combos_k):
            sel[sum_index[(t1 + t2, u1 + u2, v1 + v2)], a, b] = 1.0
    sel_t = torch.as_tensor(sel, dtype=f64, device=device)
    lmax4 = l_bra + l_ket

    def quartet_block(p, P, et1, cw1, q, Q, et2, cw2):
        """All primitive combinations of a (bra block) x (ket block).

        p,q: (nx|ny, np2) exponent sums; P,Q: (.., np2, 3);
        et: (.., np2, nc); cw: (.., np2).  -> (nx, ny)
        """
        pp = p[:, None, :, None]                  # (x, 1, c, 1)
        qq = q[None, :, None, :]                  # (1, y, 1, d)
        alpha = pp * qq / (pp + qq)               # (x, y, c, d)
        pq = P[:, None, :, None, :] - Q[None, :, None, :, :]
        r2 = torch.sum(pq * pq, dim=-1)
        f = boys(lmax4, alpha * r2)               # (lmax4+1, x, y, c, d)
        r = r_tensor(lmax4, alpha, torch.movedim(pq, -1, 0).contiguous(), f)
        r_flat = torch.stack([r[tuv] for tuv in sum_combos])
        pref = 2.0 * pi ** 2.5 / (pp * qq * torch.sqrt(pp + qq))
        # fold the primitive weights into the bra/ket Hermite coefficients
        e1w = et1 * cw1[..., None]                        # (x, c, a)
        e2w = et2 * parity * cw2[..., None]               # (y, d, b)
        # sum_{s,a,b,c,d} R[s,c,d] SEL[s,a,b] e1w[c,a] e2w[d,b] pref[c,d],
        # factored explicitly (as in the JAX package)
        h = torch.einsum("sab,ydb->syda", sel_t, e2w)
        g = torch.einsum("syda,xca->sxycd", h, e1w)
        return torch.einsum("sxycd,sxycd->xy", g, r_flat * pref[None])

    return quartet_block


def pair_data(basis: BasisSet, device="cpu"):
    """Pair stage over every unique cartesian AO pair (i <= j) -> (iu, ju,
    p, P, et, cw): numpy pair indices and the Hermite pair tensors
    (npair, 9), (npair, 9, 3), (npair, 9, nc), (npair, 9) in f64 on
    `device`.  The counterpart of the JAX package's ``_pairs_runner``."""
    n = basis.ncart
    lmax = int(basis.cart_powers.max())
    f64 = torch.float64

    def t64(x):
        return torch.as_tensor(np.asarray(x), dtype=f64, device=device)

    iu, ju = np.triu_indices(n)
    pw = torch.as_tensor(basis.cart_powers.astype(np.int64), device=device)
    ce = t64(basis.cart_centers)
    al = basis.cart_alphas
    co = basis.cart_coeffs
    a_grid = t64(np.repeat(al[iu], NPRIM, axis=1))   # (npair, 9)
    b_grid = t64(np.tile(al[ju], (1, NPRIM)))
    cw = t64(np.repeat(co[iu], NPRIM, axis=1) * np.tile(co[ju], (1, NPRIM)))

    pair_fn = _pair_stage(lmax)
    ii = torch.as_tensor(iu, device=device)
    jj = torch.as_tensor(ju, device=device)
    p_all, P_all, et_all = vmap(
        lambda i, j, a9, b9: vmap(
            lambda a, b: pair_fn(pw[i], pw[j], ce[i], ce[j], a, b)
        )(a9, b9)
    )(ii, jj, a_grid, b_grid)  # (npair, 9), (npair, 9, 3), (npair, 9, nc)
    return iu, ju, p_all, P_all, et_all, cw


def diag_runner(l_bra: int, device):
    """(ab|ab) for a block of pairs: the diagonal of the block's quartet
    block with itself (the JAX package's ``_diag_runner``)."""
    quartet = _quartet_kernel(l_bra, device)

    def run_diag(p, P, et, cw):
        return torch.diagonal(quartet(p, P, et, cw, p, P, et, cw))

    return run_diag


def eri_packed(basis: BasisSet, screen_tol: float = 1e-12,
               block: int | None = None, device="cpu"):
    """ERIs over unique cartesian AO pairs: returns (pair_idx, W) with
    W[a, b] = (i_a j_a | i_b j_b) for the Schwarz-surviving pair list
    (W a float64 tensor on `device`)."""
    lmax = int(basis.cart_powers.max())
    if block is None:
        # cap the vmapped quartet intermediate (~nc^2 * 81 doubles/quartet)
        block = 64 if lmax <= 1 else 16
    f64 = torch.float64

    iu, ju, p_all, P_all, et_all, cw = pair_data(basis, device)
    npair_all = len(iu)
    quartet = _quartet_kernel(2 * lmax, device)
    run_diag = diag_runner(2 * lmax, device)

    # --- Schwarz factors: Q_ab = sqrt((ab|ab)) ---
    diag = torch.cat([
        run_diag(p_all[s:s + block], P_all[s:s + block],
                 et_all[s:s + block], cw[s:s + block])
        for s in range(0, npair_all, block)
    ])
    q_fac = torch.sqrt(torch.abs(diag)).cpu().numpy()
    keep = q_fac * q_fac.max() > screen_tol
    sel = np.nonzero(keep)[0]
    npair = len(sel)
    sel_t = torch.as_tensor(sel, device=device)
    p_s, P_s, et_s, cw_s = (p_all[sel_t], P_all[sel_t], et_all[sel_t],
                            cw[sel_t])

    W = torch.zeros((npair, npair), dtype=f64, device=device)
    for sa in range(0, npair, block):
        ea = min(sa + block, npair)
        for sb in range(sa, npair, block):
            eb = min(sb + block, npair)
            blk = quartet(
                p_s[sa:ea], P_s[sa:ea], et_s[sa:ea], cw_s[sa:ea],
                p_s[sb:eb], P_s[sb:eb], et_s[sb:eb], cw_s[sb:eb],
            )
            W[sa:ea, sb:eb] = blk
            if sb != sa:
                W[sb:eb, sa:ea] = blk.T
    return (iu[sel], ju[sel]), W


def eri_full(basis: BasisSet, screen_tol: float = 1e-12,
             block: int | None = None, device="cpu") -> torch.Tensor:
    """Full (nao, nao, nao, nao) spherical-AO ERI tensor, float64 on
    `device`."""
    (pi_, pj_), W = eri_packed(basis, screen_tol, block, device)
    n = basis.ncart
    npair = len(pi_)
    full = torch.zeros((n, n, n, n), dtype=torch.float64, device=W.device)
    # unpack pair symmetry: (ij|kl) = (ji|kl) = (ij|lk) = (ji|lk)
    ii = torch.as_tensor(np.repeat(pi_, npair), device=W.device)
    jj = torch.as_tensor(np.repeat(pj_, npair), device=W.device)
    kk = torch.as_tensor(np.tile(pi_, npair), device=W.device)
    ll = torch.as_tensor(np.tile(pj_, npair), device=W.device)
    w = W.reshape(-1)
    for a, b in ((ii, jj), (jj, ii)):
        for c, d in ((kk, ll), (ll, kk)):
            full[a, b, c, d] = w
    c2s = basis.c2s
    if c2s.shape[0] == n and np.allclose(c2s, np.eye(n)):
        return full
    # c2s is (nao_sph, ncart): contract each cartesian index in turn
    c = torch.as_tensor(c2s, dtype=torch.float64, device=W.device)
    out = torch.einsum("ip,pqrs->iqrs", c, full)
    out = torch.einsum("jq,iqrs->ijrs", c, out)
    out = torch.einsum("kr,ijrs->ijks", c, out)
    return torch.einsum("ls,ijks->ijkl", c, out)
