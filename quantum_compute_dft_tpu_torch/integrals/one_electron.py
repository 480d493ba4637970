"""One-electron integrals: overlap S, kinetic T, nuclear attraction V.

Port of ``quantum_compute_dft_tpu/integrals/one_electron.py``: one
uniform McMurchie-Davidson kernel per cartesian AO pair (static lmax,
per-pair powers selected by indexing), mapped over the pair list with
``torch.func.vmap``, in float64 on the given device.
"""

from __future__ import annotations

from math import pi

import numpy as np
import torch
from torch.func import vmap

from quantum_compute_dft_tpu_torch.basis.basis_set import BasisSet
from quantum_compute_dft_tpu_torch.integrals.boys import boys_fast as boys
from quantum_compute_dft_tpu_torch.integrals.mcmurchie import (
    e_tables,
    hermite_combos,
    r_tensor,
)


def _pair_kernel(lmax: int):
    """Returns f(pa, pb, A, B, aa, ab, ca, cb, atom_xyz, atom_z) -> (S,T,V)
    for one AO pair (contracted over the NPRIM x NPRIM primitive grid)."""

    combos = hermite_combos(2 * lmax)

    def prim(pa, pb, A, B, a, b, atom_xyz, atom_z):
        p = a + b
        ab3 = A - B
        # E tables per dimension; jmax+2 for the kinetic ladder.
        Es = [e_tables(lmax, lmax + 2, a, b, ab3[d]) for d in range(3)]
        e0 = [Es[d][pa[d], pb[d], 0] for d in range(3)]

        pref = (pi / p) ** 1.5
        s_val = pref * e0[0] * e0[1] * e0[2]

        # kinetic: -1/2 d^2/dx^2 ladder per dimension
        d2 = []
        for d in range(3):
            j = pb[d]
            jm2 = Es[d][pa[d], torch.clamp(j - 2, min=0), 0]
            jp2 = Es[d][pa[d], j + 2, 0]
            j0 = e0[d]
            d2.append(
                j * (j - 1) * jm2 - 2.0 * b * (2 * j + 1) * j0 + 4.0 * b * b * jp2
            )
        t_val = -0.5 * pref * (
            d2[0] * e0[1] * e0[2] + e0[0] * d2[1] * e0[2] + e0[0] * e0[1] * d2[2]
        )

        # nuclear attraction over all atoms
        P = (a * A + b * B) / p
        ex = [Es[d][pa[d], pb[d], :] for d in range(3)]

        def one_atom(c_xyz, z):
            pc = P - c_xyz
            r2 = pc @ pc
            f = boys(2 * lmax, p * r2)
            r = r_tensor(2 * lmax, p, pc, f)
            acc = 0.0
            for (t, u, v) in combos:
                acc = acc + ex[0][t] * ex[1][u] * ex[2][v] * r[(t, u, v)]
            return -z * acc

        v_val = (2.0 * pi / p) * torch.sum(vmap(one_atom)(atom_xyz, atom_z))
        return s_val, t_val, v_val

    def pair(pa, pb, A, B, aa, ab, ca, cb, atom_xyz, atom_z):
        nprim = aa.shape[0]
        a_grid = torch.repeat_interleave(aa, nprim)
        b_grid = ab.repeat(nprim)
        w_grid = torch.repeat_interleave(ca, nprim) * cb.repeat(nprim)
        s, t, v = vmap(
            lambda a, b: prim(pa, pb, A, B, a, b, atom_xyz, atom_z)
        )(a_grid, b_grid)
        return w_grid @ s, w_grid @ t, w_grid @ v

    return pair


# Row budget for the fused nuclear-attraction intermediate: pairs are
# swept in chunks of at most this many (pair x prim-pair x atom) rows.
_ROW_BUDGET = 1 << 21


def _pair_chunk(natom: int, nprim: int) -> int:
    expand = max(1, natom * nprim * nprim)
    return max(1024, _ROW_BUDGET // expand)


def one_electron_cart(basis: BasisSet, atom_xyz: np.ndarray,
                      atom_z: np.ndarray, device="cpu"):
    """S, T, V in the cartesian AO basis (numpy f64), computed pairwise
    on `device`."""
    n = basis.ncart
    lmax = int(basis.cart_powers.max())
    iu, ju = np.triu_indices(n)

    def t64(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=device)

    pw = torch.as_tensor(basis.cart_powers.astype(np.int64), device=device)
    ce, al, co = t64(basis.cart_centers), t64(basis.cart_alphas), \
        t64(basis.cart_coeffs)
    axyz, az = t64(atom_xyz), t64(atom_z)
    kern = _pair_kernel(lmax)

    def run(ii, jj):
        return vmap(
            lambda i, j: kern(pw[i], pw[j], ce[i], ce[j], al[i], al[j],
                              co[i], co[j], axyz, az)
        )(ii, jj)

    chunk = _pair_chunk(len(atom_z), int(basis.cart_alphas.shape[1]))
    parts = []
    for k in range(0, iu.size, chunk):
        ii = torch.as_tensor(iu[k:k + chunk], device=device)
        jj = torch.as_tensor(ju[k:k + chunk], device=device)
        parts.append([x.cpu().numpy() for x in run(ii, jj)])
    vals = [np.concatenate([p[q] for p in parts]) for q in range(3)]

    def unpack(v):
        m = np.zeros((n, n))
        m[iu, ju] = v
        m[ju, iu] = v
        return m

    return tuple(unpack(v) for v in vals)


def one_electron(basis: BasisSet, atom_xyz: np.ndarray, atom_z: np.ndarray,
                 device="cpu"):
    """S, T, V in the spherical AO basis (numpy f64, matches the JAX
    package's one_electron)."""
    s, t, v = one_electron_cart(basis, atom_xyz, atom_z, device)
    c = basis.c2s
    return c @ s @ c.T, c @ t @ c.T, c @ v @ c.T
