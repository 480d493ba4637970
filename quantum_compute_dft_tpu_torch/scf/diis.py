"""CDIIS (Pulay commutator DIIS) and ADIIS with fixed-size histories,
torch f64.

Port of ``quantum_compute_dft_tpu/scf/diis.py`` (``DIISState``,
``diis_init``, ``diis_update``, ``ADIISState``, ``adiis_init``,
``adiis_update``).  CDIIS error vector e = X^T (F D S - S D F) X; the
extrapolation coefficients minimize c^T B c subject to sum(c) = 1,
B_ij = <e_i, e_j>, through a truncated pseudo-inverse of the unit-scaled B.

The history buffers are updated in place (the JAX package rebuilds them
functionally); callers always continue from the returned state.

``diis_update`` branches on its host counter ``nsaved``.  Its graph-safe
form (``diis_init_graph``, ``diis_push``, ``diis_extrapolate``, and
``diis_update_graph`` chaining them) keeps the counter on the device, writes
the slot by a one-hot select and replaces the branches by ``torch.where``,
so a CUDA graph (scf.driver.scf_jit) replays it correctly at every count.
It is split at its eigh, which the graph leaves outside (see scf_jit).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# relative TSVD threshold: the JAX package's CPU value.  Its TPU value
# (1e-8) exists because TPU f64 eigh is f32-quality; the card's f64 eigh
# is native, so the exact-eigh threshold holds on both devices.
TSVD_THRESH = 1e-13
# the JAX package's bound on sum |c|: a wilder extrapolation is taken for
# an ill-conditioning symptom and replaced by the newest Fock matrix
MAX_COEF_SUM = 20.0


class DIISState(NamedTuple):
    f_buf: torch.Tensor   # (M, nao, nao)
    e_buf: torch.Tensor   # (M, nao*nao)
    nsaved: int
    max_coef_sum: float = MAX_COEF_SUM


def diis_init(nao: int, space: int = 8, dtype=torch.float64,
              device="cpu", max_coef_sum: float = MAX_COEF_SUM) -> DIISState:
    return DIISState(
        f_buf=torch.zeros((space, nao, nao), dtype=dtype, device=device),
        e_buf=torch.zeros((space, nao * nao), dtype=dtype, device=device),
        nsaved=0, max_coef_sum=max_coef_sum,
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
    new = state._replace(nsaved=nsaved)
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
    coef = torch.where(torch.sum(torch.abs(coef)) < state.max_coef_sum,
                       coef, newest)
    return new, torch.einsum("i,ijk->jk", coef, state.f_buf)


class DIISGraphState(NamedTuple):
    f_buf: torch.Tensor   # (M, nao, nao)
    e_buf: torch.Tensor   # (M, nao*nao)
    nsaved: torch.Tensor  # 0-dim int64, on the buffers' device


def diis_init_graph(nao: int, space: int = 8, dtype=torch.float64,
                    device="cpu") -> DIISGraphState:
    st = diis_init(nao, space, dtype, device)
    return DIISGraphState(st.f_buf, st.e_buf,
                          torch.zeros((), dtype=torch.int64, device=device))


def diis_push(state: DIISGraphState, f, dm, s, x):
    """diis_update's insertion, functional and without host reads: ->
    (new state, the unit-scaled B matrix to diagonalize)."""
    m = state.f_buf.shape[0]
    sdf = s @ dm @ f
    err = x.T @ (f @ dm @ s - sdf) @ x
    slots = torch.arange(m, device=f.device)
    put = slots == state.nsaved % m
    f_buf = torch.where(put[:, None, None], f, state.f_buf)
    e_buf = torch.where(put[:, None], err.reshape(-1), state.e_buf)
    nsaved = state.nsaved + 1
    used = (slots < torch.clamp(nsaved, max=m)).to(f.dtype)
    b_inner = (e_buf @ e_buf.T) * (used[:, None] * used[None, :])
    scale = torch.max(torch.diagonal(b_inner)) + 1e-300
    return (DIISGraphState(f_buf, e_buf, nsaved),
            b_inner / scale + torch.diag(1.0 - used))


def diis_extrapolate(state: DIISGraphState, f, w_eig, v_eig):
    """diis_update's extrapolation from the eigenpairs of diis_push's B
    (state: the one diis_push returned; f: the Fock matrix pushed)."""
    m = state.f_buf.shape[0]
    slots = torch.arange(m, device=f.device)
    used = (slots < torch.clamp(state.nsaved, max=m)).to(f.dtype)
    inv = torch.where(torch.abs(w_eig) > TSVD_THRESH, 1.0 / w_eig,
                      torch.zeros_like(w_eig))
    u = v_eig @ (inv * (v_eig.T @ used))
    denom = used @ u
    newest = (slots == (state.nsaved - 1) % m).to(f.dtype)
    ok = torch.abs(denom) > 1e-8
    coef = torch.where(ok, u / torch.where(ok, denom, 1.0), newest) * used
    coef = torch.where(torch.sum(torch.abs(coef)) < MAX_COEF_SUM, coef,
                       newest)
    f_ext = torch.einsum("i,ijk->jk", coef, state.f_buf)
    # with a single stored matrix, extrapolation is the identity
    return torch.where(state.nsaved == 1, f, f_ext)


def diis_update_graph(state: DIISGraphState, f, dm, s, x):
    """The graph-safe diis_update: -> (state, extrapolated Fock matrix)."""
    state, b_s = diis_push(state, f, dm, s, x)
    return state, diis_extrapolate(state, f, *torch.linalg.eigh(b_s))


# ADIIS (Hu & Yang, JCP 132, 054109 (2010)): energy-based DIIS for the
# far-from-convergence phase.  It minimizes a quadratic model of the energy
# over the convex hull of the stored iterates,
#     E(c) ~ 2 sum_i c_i <D_i - D_n, F_n> + sum_ij c_i c_j <D_i - D_n, F_j - F_n>,
# c on the simplex (c = softmax(t)), so mixing can only move downhill in the
# model; CDIIS, which extrapolates the commutator, can mix iterates of
# different electronic configurations and charge-slosh forever on
# near-degenerate systems (CuO).  The driver hands over to CDIIS below
# ADIIS_TO_CDIIS.

ADIIS_STEPS = 300
ADIIS_LR = 0.2


class ADIISState(NamedTuple):
    f_buf: torch.Tensor   # (M, nao, nao)
    d_buf: torch.Tensor   # (M, nao, nao)
    nsaved: int


def adiis_init(nao: int, space: int = 8, dtype=torch.float64,
               device="cpu") -> ADIISState:
    return ADIISState(
        f_buf=torch.zeros((space, nao, nao), dtype=dtype, device=device),
        d_buf=torch.zeros((space, nao, nao), dtype=dtype, device=device),
        nsaved=0,
    )


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.max(x))
    return e / np.sum(e)


def adiis_coefficients(g: np.ndarray, h: np.ndarray, nused: int,
                       newest: int) -> np.ndarray:
    """The simplex weights c = softmax(t) minimizing the model
    m(c) = (2 c.g + c.h c) / scale by ADIIS_STEPS steps of gradient descent
    on t from 4 e_newest, in host f64.  The gradient is in closed form:
    dm/dt = c * (dm/dc - c.dm/dc), dm/dc = (2 g + (h + h^T) c) / scale.
    Unused slots carry -1e30 and get exactly zero weight."""
    m = g.shape[0]
    scale = np.max(np.abs(h)) + np.max(np.abs(g)) + 1e-300
    neg = np.where(np.arange(m) < nused, 0.0, -1e30)
    hs = h + h.T
    t = np.zeros(m)
    t[newest] = 4.0
    for _ in range(ADIIS_STEPS):
        c = _softmax(t + neg)
        dc = (2.0 * g + hs @ c) / scale
        t = t - ADIIS_LR * c * (dc - c @ dc)
    return _softmax(t + neg)


def adiis_update(state: ADIISState, f, dm):
    """Insert (F, D) and return (state, ADIIS-mixed Fock matrix).  One
    device fetch of the (M,) and (M, M) model terms; the descent runs on
    the host."""
    m = state.f_buf.shape[0]
    slot = state.nsaved % m
    state.f_buf[slot] = f
    state.d_buf[slot] = dm
    nsaved = state.nsaved + 1
    new = ADIISState(state.f_buf, state.d_buf, nsaved)
    nused = min(nsaved, m)
    if nused == 1:
        return new, f
    newest = (nsaved - 1) % m
    # over every slot, the unused (zero) ones included, as the JAX
    # package's: their terms enter `scale`
    dd = state.d_buf - state.d_buf[newest]
    df = state.f_buf - state.f_buf[newest]
    g = torch.einsum("ijk,jk->i", dd, state.f_buf[newest])
    h = torch.einsum("ijk,ljk->il", dd, df)
    gh = torch.cat([g, (0.5 * (h + h.T)).reshape(-1)]).cpu().numpy()
    c = adiis_coefficients(gh[:m], gh[m:].reshape(m, m), nused, newest)
    c_t = torch.as_tensor(c, dtype=f.dtype, device=f.device)
    return new, torch.einsum("i,ijk->jk", c_t, state.f_buf)
