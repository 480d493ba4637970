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
on the host in exact f64 numpy.  Total integral work is
O(npair * rank) quartets instead of O(npair^2).

The factor unpacks to a (nao, nao, rank) tensor that the density-fitted
J/K builders (integrals/density_fitting.py) take with an identity metric:

    J = sum_r L[:,:,r] (L[:,:,r] . D),    K = sum_r L_r D L_r^T.
"""

from __future__ import annotations

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

    timings, if given, gets the split between card and host, host seconds
    at the transfers the factorization waits at anyway: cholesky_card_s
    (the diagonal and the panels, each to the end of its transfer to the
    host), cholesky_host_s (the downdates, the in-panel factorizations, the
    unpack and its upload), cholesky_panels and eri_kernel_launches (the
    K4 launches of the factorization: the diagonal and one a panel on the
    card, 0 on the CPU)."""
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

    def run_panel(piv):
        """ERI columns W[:, piv] for one pivot block -> (npair, k) numpy,
        crossing to the host in one transfer (one synchronization per
        panel)."""
        return eri_columns(pairs, sel, sel[piv], block).cpu().numpy()

    l_cols: list[np.ndarray] = []
    it = 0
    while True:
        dmax = d.max() if npair else 0.0
        if dmax < tol or len(l_cols) >= max_rank:
            break
        # pivot block: the `block` largest residual diagonals
        cand = np.argsort(-d)[:block]
        piv = cand[d[cand] > tol]
        k = len(piv)
        with span("cholesky.panel", timings, card):
            panel = run_panel(piv)
        if l_cols:
            with span("cholesky.downdate", timings, host):
                lmat = np.concatenate(l_cols, axis=1)
                panel -= lmat @ lmat[piv].T
        # in-panel pivoted factorization (host, exact f64)
        with span("cholesky.factor", timings, host):
            for c in range(k):
                if len(l_cols) >= max_rank:
                    break
                djj = panel[piv[c], c]
                if djj < tol:
                    continue  # downdated below threshold by earlier columns
                lcol = panel[:, c] / np.sqrt(djj)
                l_cols.append(lcol[:, None])
                if c + 1 < k:
                    panel[:, c + 1:] -= (lcol[:, None]
                                         * lcol[piv[c + 1:]][None, :])
                d -= lcol * lcol
            d = np.maximum(d, 0.0)
        it += 1
        if verbose:
            print(f"  cholesky panel {it}: rank={len(l_cols)}, "
                  f"max residual diag={d.max():.3e}")

    if timings is not None:
        timings["cholesky_panels"] = it
        timings["eri_kernel_launches"] = LAUNCHES["K4"] - launches
    with span("cholesky.unpack", timings, host):
        rank = len(l_cols)
        l_pair = (np.concatenate(l_cols, axis=1) if rank
                  else np.zeros((npair, 0)))

        # unpack (pair, rank) -> symmetric (ncart, ncart, rank) -> spherical
        full = np.zeros((n, n, rank))
        full[iu, ju] = l_pair
        full[ju, iu] = l_pair
        c2s = basis.c2s
        if not (c2s.shape[0] == n and np.allclose(c2s, np.eye(n))):
            full = np.einsum("ip,jq,pqr->ijr", c2s, c2s, full, optimize=True)
        return torch.as_tensor(full, dtype=torch.float64, device=device)
