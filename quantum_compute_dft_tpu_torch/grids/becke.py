"""Becke partition weights (Becke, JCP 88, 2547 (1988)) in torch f64.

Port of ``quantum_compute_dft_tpu/grids/becke.py``: vectorized over grid
points on the device, O(ngrid * natm^2) elementwise work, with the
Appendix atomic-size adjustment from Bragg-Slater radii.
"""

from __future__ import annotations

import numpy as np
import torch


def _stepfun(mu: torch.Tensor) -> torch.Tensor:
    """Becke's thrice-iterated smoothing polynomial -> s(mu) in [0, 1]."""
    p = mu
    for _ in range(3):
        p = 0.5 * p * (3.0 - p * p)
    return 0.5 * (1.0 - p)


def becke_weights(
    coords: torch.Tensor,    # (ngrid, 3) grid points
    atom_xyz: torch.Tensor,  # (natm, 3)
    atom_idx: torch.Tensor,  # (ngrid,) owning atom of each point
    radii: torch.Tensor,     # (natm,) Bragg radii (bohr)
) -> torch.Tensor:
    """Partition weight of each point w.r.t. its owning atom."""
    natm = atom_xyz.shape[0]
    eye = torch.eye(natm, dtype=torch.bool, device=coords.device)
    # distances point -> every atom: (ngrid, natm)
    d = torch.linalg.norm(coords[:, None, :] - atom_xyz[None, :, :], dim=-1)
    # interatomic distances (natm, natm)
    rab = torch.linalg.norm(atom_xyz[:, None, :] - atom_xyz[None, :, :], dim=-1)
    rab = torch.where(eye, 1.0, rab)

    # size-adjustment parameter a_ij from Bragg radii (Becke appendix)
    chi = radii[:, None] / radii[None, :]
    u = (chi - 1.0) / (chi + 1.0)
    a = torch.clamp(u / (u * u - 1.0), -0.5, 0.5)

    # mu_ij per point: (ngrid, natm, natm)
    mu = (d[:, :, None] - d[:, None, :]) / rab[None, :, :]
    nu = mu + a[None, :, :] * (1.0 - mu * mu)
    s = torch.where(eye[None, :, :], 1.0, _stepfun(nu))  # no self factor
    p_cell = torch.prod(s, dim=2)          # (ngrid, natm): P_i(r)
    w_own = torch.gather(p_cell, 1, atom_idx[:, None].long())[:, 0]
    return w_own / torch.sum(p_cell, dim=1)


def becke_weights_chunked(coords, atom_xyz, atom_idx, radii, chunk=None,
                          device="cpu") -> np.ndarray:
    """Host-driven chunking over the grid (bounds the (chunk, natm, natm)
    intermediates); numpy in, numpy out, computed on `device`.  The
    default chunk is 65,536 points, cut for large molecules so that one
    intermediate stays at 2^27 f64 elements (1 GiB; 9,805 points at 117
    atoms)."""
    if chunk is None:
        natm = len(atom_xyz)
        chunk = min(65536, max(1024, 2**27 // (natm * natm)))

    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    xyz, rad = t(atom_xyz), t(radii)
    out = []
    for s in range(0, coords.shape[0], chunk):
        e = min(s + chunk, coords.shape[0])
        out.append(becke_weights(t(coords[s:e]), xyz,
                                 t(atom_idx[s:e], torch.int64), rad)
                   .cpu().numpy())
    return np.concatenate(out)
