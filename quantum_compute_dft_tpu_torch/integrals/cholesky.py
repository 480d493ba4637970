"""Pivoted Cholesky decomposition of the two-electron integral matrix.

Port of ``quantum_compute_dft_tpu/integrals/cholesky.py``: the ERI matrix
over unique AO pairs, W[(ij),(kl)] = (ij|kl), is symmetric positive
semi-definite, so a pivoted Cholesky factorization W ~= L L^T truncated at
residual-diagonal threshold `tol` guarantees

    |(ij|kl) - sum_r L[ij,r] L[kl,r]|  <=  sqrt(d_ij d_kl)  <=  tol

element-wise.  Blocked pivot panels: each outer iteration picks the
`block` largest residual diagonals, evaluates their ERI columns on the
device with the in-core path's quartet stage (integrals/two_electron.py:
on the card one K4 launch for the diagonal and one a panel), and downdates
it in exact f64 on the same device: one GEMM a panel against the vectors
so far, then one rank-1 update a column inside the panel.  The host keeps
the pivot order, from the residual diagonal that crosses to it once a
panel, and reads each pivot's residual.  Total integral work is
O(npair * rank) quartets instead of O(npair^2).

The factor unpacks to a (nao, nao, rank) tensor that the density-fitted
J/K builders (integrals/density_fitting.py) take with an identity metric:

    J = sum_r L[:,:,r] (L[:,:,r] . D),    K = sum_r L_r D L_r^T.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.basis.basis_set import BasisSet
from quantum_compute_dft_tpu_torch.integrals.two_electron import (
    LAUNCHES,
    eri_columns,
    eri_diagonal,
    pair_data,
    quartet_pairs,
)
from quantum_compute_dft_tpu_torch.utils.profiling import span

# pivots per panel and pairs per eager quartet tile (the CPU path): the
# JAX package's device block
BLOCK = 128


def cholesky_eri_vectors(
    basis: BasisSet,
    tol: float = 1e-7,
    block: int = BLOCK,
    max_rank: int | None = None,
    device="cpu",
    verbose: bool = False,
    timings: dict | None = None,
) -> torch.Tensor:
    """-> L (nao, nao, rank) f64 spherical-AO Cholesky vectors on `device`
    with max residual diagonal < tol (guaranteed elementwise ERI error).

    timings, if given, gets the split between the integrals and the
    factorization, host seconds to a synchronization at the end of each:
    cholesky_card_s (the diagonal and the panels' ERI columns),
    cholesky_host_s (the downdates, the in-panel factorizations and the
    unpack, on the factor's device, paced by the host's pivot loop),
    cholesky_panels and eri_kernel_launches (the K4 launches of the
    factorization: the diagonal and one a panel on the card, 0 on the
    CPU)."""
    card, host = "cholesky_card_s", "cholesky_host_s"
    n = basis.ncart
    lmax = int(basis.cart_powers.max())
    launches = LAUNCHES["K4"]
    iu, ju, *hermite = pair_data(basis, device)
    pairs = quartet_pairs(*hermite, 2 * lmax)
    npair = len(iu)

    # residual diagonal d_ab = (ab|ab) over ALL pairs, then one host
    # transfer
    with span("cholesky.diag", timings, card):
        d_full = eri_diagonal(pairs, np.arange(npair), block).cpu().numpy()
    d_full = np.maximum(d_full, 0.0)

    # Schwarz screening: |(ab|cd)| <= sqrt(d_ab d_cd) <= sqrt(d_ab d_max),
    # so pairs with d_ab <= tol^2 / d_max contribute < tol to every ERI
    # element and are dropped from the factorization (their L rows are
    # exactly zero)
    dmax = d_full.max() if npair else 0.0
    keep = d_full > (tol * tol) / max(dmax, 1e-300)
    sel = np.nonzero(keep)[0]
    iu, ju = iu[sel], ju[sel]
    d = d_full[sel]
    npair = len(sel)
    if verbose:
        print(f"  cholesky: {npair}/{len(d_full)} pairs survive Schwarz "
              f"screening at tol={tol:g}")

    if max_rank is None:
        max_rank = min(npair, 16 * basis.nao + 64)
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    d = torch.as_tensor(d, **f64)
    # the factor, one row a vector: rows [:rank] are L^T
    lbuf = torch.zeros((max_rank, npair), **f64)
    rank = 0
    it = 0
    while True:
        # the residual diagonal crosses to the host once a panel, for the
        # stop test and the pivot order
        d_host = d.cpu().numpy()
        dmax = d_host.max() if npair else 0.0
        if dmax < tol or rank >= max_rank:
            break
        # pivot block: the `block` largest residual diagonals
        cand = np.argsort(-d_host)[:block]
        piv = cand[d_host[cand] > tol]
        k = len(piv)
        piv_t = torch.as_tensor(piv, device=dev)
        with span("cholesky.panel", timings, card):
            panel = eri_columns(pairs, sel, sel[piv], block)
            _sync(dev)
        if rank:
            with span("cholesky.downdate", timings, host):
                lmat = lbuf[:rank]
                panel -= lmat.T @ lmat[:, piv_t]
        # in-panel pivoted factorization (exact f64, on the factor's
        # device; the host reads each pivot's residual, one sync a column)
        with span("cholesky.factor", timings, host):
            for c in range(k):
                if rank >= max_rank:
                    break
                djj = float(panel[piv[c], c])
                if djj < tol:
                    continue  # downdated below threshold by earlier columns
                lcol = panel[:, c] / math.sqrt(djj)
                lbuf[rank] = lcol
                rank += 1
                if c + 1 < k:
                    panel[:, c + 1:].addr_(lcol, lcol[piv_t[c + 1:]],
                                           alpha=-1.0)
                d.addcmul_(lcol, lcol, value=-1.0)
            d.clamp_(min=0.0)
            _sync(dev)
        it += 1
        if verbose:
            print(f"  cholesky panel {it}: rank={rank}, "
                  f"max residual diag={float(d.max()):.3e}")

    if timings is not None:
        timings["cholesky_panels"] = it
        timings["eri_kernel_launches"] = LAUNCHES["K4"] - launches
    with span("cholesky.unpack", timings, host):
        # unpack (pair, rank) -> symmetric (ncart, ncart, rank) -> spherical
        l_pair = lbuf[:rank].T
        rows = torch.as_tensor(iu, device=dev)
        cols = torch.as_tensor(ju, device=dev)
        full = torch.zeros((n, n, rank), **f64)
        full[rows, cols] = l_pair
        full[cols, rows] = l_pair
        del lbuf, l_pair
        c2s = basis.c2s
        if not (c2s.shape[0] == n and np.allclose(c2s, np.eye(n))):
            c2s = torch.as_tensor(c2s, **f64)
            full = torch.einsum("ip,jq,pqr->ijr", c2s, c2s, full)
        _sync(dev)
        return full


def _sync(dev: torch.device) -> None:
    """Wait for the card, so a span's host seconds hold its device work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
