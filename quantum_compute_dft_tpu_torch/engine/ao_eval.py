"""AO values (and gradients) at grid points, torch f64 on the device.

Port of ``quantum_compute_dft_tpu/engine/ao_eval.py`` (deriv 0 and 1).
Evaluates the flat primitive-term table from basis_set.py:

    phi_ao(r) = sum_t  w[ao,t] * dx^px dy^py dz^pz * exp(-alpha[ao,t] |d|^2)

with d = r - center[ao].  On CUDA tensors ``eval_ao`` is one launch of
kernel K5 (``csrc/ao_eval.cu``: one thread an output, the whole grid in one
launch, nothing intermediate in device memory) on the table ``pack_table``
lays out, counted in ``LAUNCHES``; the wrapper builds K5 at first use
(nvcc, keyed by a hash of the source, as ``engine/fused_xc.py`` builds
K1-K3) and binds it with ctypes.  On CPU tensors it runs the plain version,
``eval_ao_reference`` (eager broadcast chunks of ``_eval_chunk``, which
also run on the card, for comparison).  No fallback: a CUDA tensor launches
K5 or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.basis.basis_set import BasisSet
from quantum_compute_dft_tpu_torch.engine.fused_xc import (
    _on,
    _stream,
    build_library,
)

_PMAX = 5  # max monomial power needed (l=4 aux) + 1 for gradients


def _int_pow(base, p):
    """base ** p for a small-integer tensor p, by select over chained
    multiplications (the same arithmetic as the JAX package)."""
    out = torch.ones_like(base)
    acc = torch.ones_like(base)
    for k in range(1, _PMAX + 1):
        acc = acc * base
        out = torch.where(p == k, acc, out)
    return out


def _eval_chunk(coords, centers, powers, alphas, weights, with_grad: bool):
    # coords (G,3); centers (nao,3); powers (nao,T,3); alphas/weights (nao,T)
    d = coords[:, None, :] - centers[None, :, :]          # (G, nao, 3)
    r2 = torch.sum(d * d, dim=-1)                         # (G, nao)
    arg = -alphas[None, :, :] * r2[:, :, None]            # (G, nao, T)
    # the JAX package cuts the exp tail at -85 (exp(-85) ~ 1e-37); kept so
    # both packages evaluate the same function
    ex = torch.where(arg > -85.0, torch.exp(torch.clamp(arg, min=-85.0)), 0.0)

    p = powers[None, :, :, :]                             # (1, nao, T, 3)
    dxyz = d[:, :, None, :]                               # (G, nao, 1, 3)
    mono = torch.prod(_int_pow(dxyz, p), dim=-1)          # (G, nao, T)
    w = weights[None, :, :]
    ao = torch.sum(w * mono * ex, dim=-1)                 # (G, nao)
    if not with_grad:
        return ao, None

    # d/dk of each term: (p_k d_k^{p_k-1} - 2 a d_k^{p_k+1}) * (other dims)
    grads = []
    pm1 = torch.clamp(p - 1, min=0)
    for k in range(3):
        dk = dxyz[..., k]
        poly_dk = torch.where(p[..., k] > 0,
                              p[..., k] * _int_pow(dk, pm1[..., k]), 0.0)
        other = torch.prod(
            torch.stack(
                [_int_pow(dxyz[..., m], p[..., m]) for m in range(3) if m != k],
                -1,
            ),
            dim=-1,
        )
        dmono = (poly_dk - 2.0 * alphas[None] * _int_pow(dk, p[..., k] + 1)) * other
        grads.append(torch.sum(w * dmono * ex, dim=-1))
    return ao, torch.stack(grads)                         # (G,nao), (3,G,nao)


def eval_ao(
    basis: BasisSet,
    coords,
    deriv: int = 0,
    chunk: int = 16384,
    device="cpu",
):
    """-> ao (ngrid, nao) [deriv=0] or (ao, ao_grad (3, ngrid, nao))
    [deriv=1], contiguous float64 tensors on `device` (planar gradient
    layout, as in the JAX package).  CUDA: one K5 launch (`chunk` unused);
    CPU: the plain version."""
    device = torch.device(device)
    if device.type == "cpu":
        return eval_ao_reference(basis, coords, deriv, chunk, device)
    crd = torch.as_tensor(np.asarray(coords), dtype=torch.float64,
                          device=device).contiguous()
    return _k5(pack_table(basis, device), crd, deriv)


def eval_ao_reference(
    basis: BasisSet,
    coords,
    deriv: int = 0,
    chunk: int = 16384,
    device="cpu",
):
    """Plain version of eval_ao: eager broadcast chunks of `chunk` points
    (``_eval_chunk``), on any device."""
    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    centers, alphas, weights = (t(basis.ao_centers), t(basis.term_alphas),
                                t(basis.term_weights))
    powers = t(basis.term_powers, torch.int64)
    crd = t(coords)
    aos, gs = [], []
    for s in range(0, crd.shape[0], chunk):
        ao, g = _eval_chunk(crd[s:s + chunk], centers, powers, alphas,
                            weights, deriv >= 1)
        aos.append(ao)
        gs.append(g)
    ao = torch.cat(aos)
    if deriv == 0:
        return ao
    return ao, torch.cat(gs, dim=1)


# ---------------------------------------------------------------------------
# K5 (csrc/ao_eval.cu)
# ---------------------------------------------------------------------------

K5_SOURCES = ("ao_eval.cu",)
# the largest monomial power K5 takes (its gradient reaches d^(K5_PMAX + 1))
K5_PMAX = 4
# K5 launches, counted by the wrapper where it launches
LAUNCHES = {"K5": 0}
_K5_LIB = None


class AOTable(NamedTuple):
    """The basis set's term table as K5 reads it, field-major: `table`
    (3 + 2T, nao) f64, the AO centres' x, y and z rows, then T rows of
    exponents alpha and T of weights; `powers` (T, nao) int32, a term's
    monomial powers as px + 8 py + 64 pz."""
    table: torch.Tensor
    powers: torch.Tensor


def pack_table(basis: BasisSet, device="cpu") -> AOTable:
    """K5's table of `basis` on `device`; raises ValueError on a table K5
    does not take (a power outside 0..K5_PMAX)."""
    centers = np.asarray(basis.ao_centers, dtype=np.float64)
    alphas = np.asarray(basis.term_alphas, dtype=np.float64)
    weights = np.asarray(basis.term_weights, dtype=np.float64)
    powers = np.asarray(basis.term_powers)
    nao, nterm = alphas.shape
    if (nao == 0 or nterm == 0 or centers.shape != (nao, 3)
            or weights.shape != (nao, nterm)
            or powers.shape != (nao, nterm, 3)):
        raise ValueError("the term table is not (nao, T) exponents and "
                         "weights, (nao, T, 3) powers and (nao, 3) centres")
    if powers.min() < 0 or powers.max() > K5_PMAX:
        raise ValueError(f"K5 takes monomial powers 0..{K5_PMAX}, not "
                         f"{int(powers.min())}..{int(powers.max())}")
    table = np.concatenate([centers.T, alphas.T, weights.T])
    packed = (powers[..., 0] + 8 * powers[..., 1] + 64 * powers[..., 2]).T
    return AOTable(
        torch.as_tensor(np.ascontiguousarray(table), device=device),
        torch.as_tensor(np.ascontiguousarray(packed, dtype=np.int32),
                        device=device))


def k5_library() -> ctypes.CDLL:
    """K5 built and bound (the first use builds it)."""
    global _K5_LIB
    if _K5_LIB is None:
        lib = ctypes.CDLL(str(build_library("ao_eval", K5_SOURCES)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ao_eval.argtypes = [i] * 4 + [p] * 6
        lib.ao_eval.restype = i
        _K5_LIB = lib
    return _K5_LIB


def _k5(tab: AOTable, coords: torch.Tensor, deriv: int):
    table, powers = tab
    dev = coords.device
    nterm, nao = powers.shape
    if deriv not in (0, 1):
        raise ValueError(f"K5 takes deriv 0 or 1, not {deriv}")
    if not (coords.is_cuda and table.device == dev and powers.device == dev):
        raise ValueError("K5 needs the coordinates and the table on one "
                         "CUDA device")
    if (coords.dtype != torch.float64 or coords.dim() != 2
            or coords.shape[1] != 3 or not coords.is_contiguous()
            or table.dtype != torch.float64
            or table.shape != (3 + 2 * nterm, nao)
            or not table.is_contiguous() or powers.dtype != torch.int32
            or not powers.is_contiguous()):
        raise ValueError("K5 takes contiguous (ngrid, 3) f64 coordinates "
                         "and the table of pack_table")
    ngrid = coords.shape[0]
    if ngrid >= 2**31:
        raise ValueError(f"K5 takes fewer than 2**31 points, not {ngrid}")
    ao = torch.empty((ngrid, nao), dtype=torch.float64, device=dev)
    grad = (torch.empty((3, ngrid, nao), dtype=torch.float64, device=dev)
            if deriv else None)
    if ngrid:
        with _on(dev):
            code = k5_library().ao_eval(
                deriv, ngrid, nao, nterm, coords.data_ptr(),
                table.data_ptr(), powers.data_ptr(), ao.data_ptr(),
                None if grad is None else grad.data_ptr(), _stream())
        if code != 0:
            raise RuntimeError(f"ao_eval launch (deriv {deriv}, {ngrid} x "
                               f"{nao}): CUDA error {code}")
        LAUNCHES["K5"] += 1
    return ao if deriv == 0 else (ao, grad)
