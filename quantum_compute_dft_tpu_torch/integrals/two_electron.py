"""Two-electron repulsion integrals (ij|kl) via McMurchie-Davidson, torch f64.

Port of ``quantum_compute_dft_tpu/integrals/two_electron.py``, same
two-stage formulation:

  1. *Pair stage* -- for every unique cartesian AO pair and every primitive
     pair, the combined Hermite coefficients Etilde_{tuv} = Ex[t] Ey[u] Ez[v]
     plus (p, P, coefficient).
  2. *Quartet stage* -- a uniform kernel over (bra pair, ket pair)
     contracting Etilde_bra x Etilde_ket against the Hermite Coulomb
     tensor R(alpha, P-Q).

Schwarz screening (|(ij|kl)| <= Q_ij Q_kl) compacts the pair list before
the quartet stage.

The quartet stage has three entry points over index lists into a pair
list (``quartet_pairs``): ``eri_diagonal`` ((ab|ab) alone), ``eri_columns``
(the (rows, cols) block: a pivot panel of the Cholesky factorization) and
``eri_matrix`` (the symmetric in-core matrix).  On CUDA tensors each is one
launch of kernel K4 (``csrc/eri_quartet.cu``: one thread a contracted
quartet, everything in registers), counted in ``LAUNCHES``; the wrapper
builds K4 at first use for the pair list's L (nvcc, keyed by a hash of
the source, as ``engine/fused_xc.py`` builds K1-K3) and binds it with
ctypes.  On CPU tensors each runs the plain version, ``_quartet_kernel``'s
eager tiles over blocks of `block` pairs (``eri_*_reference``, which also
run on the card, for comparison).  No fallback: a CUDA tensor launches K4
or raises.
"""

from __future__ import annotations

import ctypes
from math import pi
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from quantum_compute_dft_tpu_torch.basis.basis_set import NPRIM, BasisSet
from quantum_compute_dft_tpu_torch.engine.fused_xc import (
    _on,
    _stream,
    build_library,
)
from quantum_compute_dft_tpu_torch.integrals.boys import (
    _TABLE_TERMS,
    _taylor_table,
)
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


# ---------------------------------------------------------------------------
# the quartet stage's entry points: K4 on the card, the eager tiles on the CPU
# ---------------------------------------------------------------------------

# K4's modes (csrc/eri_quartet.cu::eri_quartet)
_COLUMNS, _MATRIX, _DIAGONAL = 0, 1, 2
K4_SOURCES = ("eri_quartet.cu",)
# K4 launches, counted by the wrapper where it launches
LAUNCHES = {"K4": 0}
_K4_LIBS: dict[int, ctypes.CDLL] = {}


class QuartetPairs(NamedTuple):
    """pair_data's Hermite tensors of a pair list (p, P, et, cw: one row a
    pair) and their angular-momentum bound l_pair = 2 lmax; on CUDA also
    K4's inputs, made once: the packed table (9, 4 + nc, npair) (per
    primitive p, P and et * cw, pairs contiguous) and boys_fast's Taylor
    table at orders 2 l_pair .. 2 l_pair + 7, (nodes, 8)."""
    p: torch.Tensor
    P: torch.Tensor
    et: torch.Tensor
    cw: torch.Tensor
    l_pair: int
    table: torch.Tensor | None = None
    boys_nodes: torch.Tensor | None = None


def quartet_pairs(p, P, et, cw, l_pair: int) -> QuartetPairs:
    if not p.is_cuda:
        return QuartetPairs(p, P, et, cw, l_pair)
    table = torch.cat([p[..., None], P, et * cw[..., None]], dim=-1)
    mmax = 2 * l_pair
    nodes = _taylor_table(mmax)[mmax:mmax + _TABLE_TERMS + 1].T
    return QuartetPairs(
        p, P, et, cw, l_pair, table.permute(1, 2, 0).contiguous(),
        torch.as_tensor(np.ascontiguousarray(nodes), dtype=torch.float64,
                        device=p.device))


def _take(pairs: QuartetPairs, idx) -> tuple:
    idx = torch.as_tensor(np.asarray(idx), device=pairs.p.device)
    return pairs.p[idx], pairs.P[idx], pairs.et[idx], pairs.cw[idx]


def eri_diagonal_reference(pairs: QuartetPairs, rows, block: int):
    """Plain version of eri_diagonal: the diagonals of the eager
    (block x block) tiles."""
    run_diag = diag_runner(pairs.l_pair, pairs.p.device)
    r = _take(pairs, rows)
    return torch.cat([run_diag(*(t[s:s + block] for t in r))
                      for s in range(0, len(rows), block)])


def eri_columns_reference(pairs: QuartetPairs, rows, cols, block: int):
    """Plain version of eri_columns: eager (block x len(cols)) tiles, all
    queued before the caller's transfer."""
    quartet = _quartet_kernel(pairs.l_pair, pairs.p.device)
    r, c = _take(pairs, rows), _take(pairs, cols)
    return torch.cat([quartet(*(t[s:s + block] for t in r), *c)
                      for s in range(0, len(rows), block)])


def eri_matrix_reference(pairs: QuartetPairs, rows, block: int):
    """Plain version of eri_matrix: eager (block x block) tiles on and
    above the diagonal, each off-diagonal tile mirrored."""
    quartet = _quartet_kernel(pairs.l_pair, pairs.p.device)
    r = _take(pairs, rows)
    n = len(rows)
    W = torch.zeros((n, n), dtype=torch.float64, device=pairs.p.device)
    for sa in range(0, n, block):
        ea = min(sa + block, n)
        for sb in range(sa, n, block):
            eb = min(sb + block, n)
            blk = quartet(*(t[sa:ea] for t in r), *(t[sb:eb] for t in r))
            W[sa:ea, sb:eb] = blk
            if sb != sa:
                W[sb:eb, sa:ea] = blk.T
    return W


def eri_diagonal(pairs: QuartetPairs, rows, block: int):
    """(ab|ab) for the pairs `rows` (indices into `pairs`) -> (len(rows),)
    f64.  CUDA: one K4 launch (`block` unused); CPU: the plain version."""
    if pairs.p.is_cuda:
        return _k4(pairs, _DIAGONAL, rows)
    return eri_diagonal_reference(pairs, rows, block)


def eri_columns(pairs: QuartetPairs, rows, cols, block: int):
    """W[rows][:, cols], (row pair | column pair) -> (len(rows), len(cols))
    f64.  CUDA: one K4 launch (`block` unused); CPU: the plain version."""
    if pairs.p.is_cuda:
        return _k4(pairs, _COLUMNS, rows, cols)
    return eri_columns_reference(pairs, rows, cols, block)


def eri_matrix(pairs: QuartetPairs, rows, block: int):
    """The symmetric W over the pairs `rows` -> (len(rows), len(rows)) f64.
    CUDA: one K4 launch (`block` unused); CPU: the plain version."""
    if pairs.p.is_cuda:
        return _k4(pairs, _MATRIX, rows)
    return eri_matrix_reference(pairs, rows, block)


def k4_library(l_pair: int) -> ctypes.CDLL:
    """K4 built for one L and bound (first use per L builds it)."""
    if l_pair not in _K4_LIBS:
        path = build_library(f"eri_quartet_L{l_pair}", K4_SOURCES,
                             (f"-DK4_L={l_pair}",))
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.eri_quartet.argtypes = [i, i, p, p, p, i, p, i, p, p]
        lib.eri_quartet.restype = i
        lib.eri_quartet_l.restype = i
        if lib.eri_quartet_l() != l_pair:
            raise RuntimeError(f"{path} is not K4 at L={l_pair}")
        _K4_LIBS[l_pair] = lib
    return _K4_LIBS[l_pair]


def _index(idx, npair: int, device) -> torch.Tensor:
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= npair):
        raise ValueError(f"pair index outside 0..{npair - 1}")
    return torch.as_tensor(idx.astype(np.int32), device=device)


def _k4(pairs: QuartetPairs, mode: int, rows, cols=None) -> torch.Tensor:
    if pairs.l_pair not in (0, 2, 4):
        raise ValueError(f"K4 takes l_pair 0, 2 or 4, not {pairs.l_pair}")
    table, nodes = pairs.table, pairs.boys_nodes
    dev = pairs.p.device
    nf, npair = table.shape[1], table.shape[2]
    if (table.shape[0] != NPRIM * NPRIM or nf != 4 + pairs.et.shape[-1]
            or pairs.et.shape[-1] != len(hermite_combos(pairs.l_pair))
            or nodes.shape[1] != _TABLE_TERMS + 1
            or table.dtype != torch.float64 or not table.is_contiguous()):
        raise ValueError("pairs do not hold K4's packed inputs (see "
                         "quartet_pairs)")
    r = _index(rows, npair, dev)
    c = None if cols is None else _index(cols, npair, dev)
    nrow, ncol = len(r), (0 if c is None else len(c))
    shape = {_COLUMNS: (nrow, ncol), _MATRIX: (nrow, nrow),
             _DIAGONAL: (nrow,)}[mode]
    out = torch.empty(shape, dtype=torch.float64, device=dev)
    if out.numel() == 0:
        return out
    lib = k4_library(pairs.l_pair)
    with _on(dev):
        code = lib.eri_quartet(
            mode, npair, table.data_ptr(), nodes.data_ptr(), r.data_ptr(),
            nrow, None if c is None else c.data_ptr(), ncol, out.data_ptr(),
            _stream())
    if code != 0:
        raise RuntimeError(f"eri_quartet launch (mode {mode}, {nrow} x "
                           f"{ncol}): CUDA error {code}")
    LAUNCHES["K4"] += 1
    return out


def k4_flops(l_pair: int) -> int:
    """f64 operations of one primitive quartet as K4 computes it (an FMA
    counts two; exp and rsqrt one each): the pair geometry 14 (P - Q,
    p + q and its rsqrt, alpha, alpha |PQ|^2), the Boys function's table
    branch 25 + 4 LT (LT = 2 l_pair: the node, 7 Taylor steps, exp, the
    downward recursion), (-2 alpha)^n LT + 1, the R recursion (one product
    an entry, plus an FMA where the recursion index is above 1, and one
    product for each layer's R_000), the contraction 2 nc^2 + 2 nc (nc
    Hermite combinations a pair) and the prefactor and the sum 5."""
    lt = 2 * l_pair
    rec = 0
    for n in range(lt, -1, -1):
        for (t, u, v) in hermite_combos(lt - n)[1:]:
            k = t if t > 0 else u if u > 0 else v
            rec += 1 if k == 1 else 3
        rec += 1
    nc = len(hermite_combos(l_pair))
    return 14 + 25 + 4 * lt + lt + 1 + rec + 2 * nc * nc + 2 * nc + 5


def eri_packed(basis: BasisSet, screen_tol: float = 1e-12,
               block: int | None = None, device="cpu"):
    """ERIs over unique cartesian AO pairs: returns (pair_idx, W) with
    W[a, b] = (i_a j_a | i_b j_b) for the Schwarz-surviving pair list
    (W a float64 tensor on `device`).  On the card the diagonal and W are
    one K4 launch each; `block` (pairs per eager tile) tiles only the CPU
    path."""
    lmax = int(basis.cart_powers.max())
    if block is None:
        # cap the quartet intermediate (~nc^2 * 81 doubles/quartet)
        block = 64 if lmax <= 1 else 16

    iu, ju, p_all, P_all, et_all, cw = pair_data(basis, device)
    pairs = quartet_pairs(p_all, P_all, et_all, cw, 2 * lmax)

    # --- Schwarz factors: Q_ab = sqrt((ab|ab)) ---
    diag = eri_diagonal(pairs, np.arange(len(iu)), block)
    q_fac = torch.sqrt(torch.abs(diag)).cpu().numpy()
    keep = q_fac * q_fac.max() > screen_tol
    sel = np.nonzero(keep)[0]
    return (iu[sel], ju[sel]), eri_matrix(pairs, sel, block)


def eri_full(basis: BasisSet, screen_tol: float = 1e-12,
             block: int | None = None, device="cpu") -> torch.Tensor:
    """Full (nao, nao, nao, nao) spherical-AO ERI tensor, float64 on
    `device` (`block`: eri_packed's, the CPU path's tile)."""
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
