"""AO values (and gradients) at grid points, torch f64 on the device.

Port of ``quantum_compute_dft_tpu/engine/ao_eval.py`` (deriv 0 and 1).
Evaluates the flat primitive-term table from basis_set.py:

    phi_ao(r) = sum_t  w[ao,t] * dx^px dy^py dz^pz * exp(-alpha[ao,t] |d|^2)

with d = r - center[ao] -- pure elementwise/broadcast work.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.basis.basis_set import BasisSet

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
    [deriv=1], float64 tensors on `device` (planar gradient layout, as in
    the JAX package)."""
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
