"""CDIIS (Pulay commutator DIIS) with a fixed-size history, torch f64.

Port of ``quantum_compute_dft_tpu/scf/diis.py`` (``DIISState``,
``diis_init``, ``diis_update``).  Error vector e = X^T (F D S - S D F) X;
the extrapolation coefficients minimize c^T B c subject to sum(c) = 1,
B_ij = <e_i, e_j>, through a truncated pseudo-inverse of the unit-scaled B.

The history buffers are updated in place (the JAX package rebuilds them
functionally); callers always continue from the returned state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# relative TSVD threshold: the JAX package's CPU value.  Its TPU value
# (1e-8) exists because TPU f64 eigh is f32-quality; the card's f64 eigh
# is native, so the exact-eigh threshold holds on both devices.
TSVD_THRESH = 1e-13


class DIISState(NamedTuple):
    f_buf: torch.Tensor   # (M, nao, nao)
    e_buf: torch.Tensor   # (M, nao*nao)
    nsaved: int


def diis_init(nao: int, space: int = 8, dtype=torch.float64,
              device="cpu") -> DIISState:
    return DIISState(
        f_buf=torch.zeros((space, nao, nao), dtype=dtype, device=device),
        e_buf=torch.zeros((space, nao * nao), dtype=dtype, device=device),
        nsaved=0,
    )


def diis_update(state: DIISState, f, dm, s, x):
    """Insert (F, error) and return (state, extrapolated Fock matrix)."""
    m = state.f_buf.shape[0]
    sdf = s @ dm @ f
    err = x.T @ (f @ dm @ s - sdf) @ x
    slot = state.nsaved % m
    state.f_buf[slot] = f
    state.e_buf[slot] = err.reshape(-1)
    nsaved = state.nsaved + 1
    nused = min(nsaved, m)
    new = DIISState(state.f_buf, state.e_buf, nsaved)
    if nused == 1:
        return new, f   # with a single stored matrix, extrapolation is id

    used = (torch.arange(m, device=f.device) < nused).to(f.dtype)
    b_inner = state.e_buf @ state.e_buf.T                 # (M, M)
    b_inner = b_inner * (used[:, None] * used[None, :])
    scale = torch.max(torch.diagonal(b_inner)) + 1e-300
    b_s = b_inner / scale + torch.diag(1.0 - used)
    w_eig, v_eig = torch.linalg.eigh(b_s)
    inv = torch.where(torch.abs(w_eig) > TSVD_THRESH, 1.0 / w_eig,
                      torch.zeros_like(w_eig))
    u = v_eig @ (inv * (v_eig.T @ used))
    denom = used @ u
    newest = torch.zeros(m, dtype=f.dtype, device=f.device)
    newest[(nsaved - 1) % m] = 1.0
    ok = torch.abs(denom) > 1e-8
    coef = torch.where(ok, u / torch.where(ok, denom, 1.0), newest) * used
    # distrust wild extrapolations (an ill-conditioning symptom)
    coef = torch.where(torch.sum(torch.abs(coef)) < 20.0, coef, newest)
    return new, torch.einsum("i,ijk->jk", coef, state.f_buf)
