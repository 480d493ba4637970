"""The molecular grid the configurations state, built for the reference.

Atom-centered shells: Treutler-Ahlrichs M4 radial points over
Gauss-Chebyshev (2nd kind) nodes, Lebedev angular points (scipy), the
NWChem-style pruning near the nucleus and in the tail, and Becke's
partition with the Bragg-radius size adjustment (Becke, JCP 88, 2547
(1988)).  Level 3 is 55 radial points and degree 29 for H, 70 and 29 for
C, N and O, 80 and 35 for P and S.  A copy, frozen here, of the definition
the program builds (its radial xi scales and its level table).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.integrate import lebedev_rule

from .basis import Z_OF, bragg_bohr

# Treutler-Ahlrichs xi scales
_XI = {"H": 0.8, "C": 1.1, "N": 0.9, "O": 0.9, "P": 1.1, "S": 1.0}
# level -> (radial points, Lebedev degree) for periods 1, 2 and 3
LEVELS = {1: ((35, 45, 50), (17, 19, 19)), 3: ((55, 70, 80), (29, 29, 35))}


def period(sym: str) -> int:
    """0, 1 or 2 for periods 1, 2 and 3: the index into LEVELS."""
    z = Z_OF[sym]
    return 0 if z <= 2 else 1 if z <= 10 else 2


def radial(n: int, sym: str):
    """(r, w) with w holding the r^2 volume factor, ascending r."""
    xi = _XI[sym]
    i = np.arange(1, n + 1)
    t = i * np.pi / (n + 1)
    x = np.cos(t)
    w_cheb = np.pi / (n + 1) * np.sin(t) ** 2
    dx = w_cheb / np.sqrt(1.0 - x ** 2)
    ln2 = np.log(2.0)
    op = (1.0 + x) ** 0.6
    lg = np.log(2.0 / (1.0 - x))
    r = xi / ln2 * op * lg
    drdx = xi / ln2 * op * (0.6 * lg / (1.0 + x) + 1.0 / (1.0 - x))
    w = dx * drdx * r * r
    order = np.argsort(r)
    return r[order], w[order]


def lebedev(degree: int):
    x, w = lebedev_rule(degree)
    return np.ascontiguousarray(x.T), w


def prune(sym: str, r: np.ndarray, degree: int) -> np.ndarray:
    rb = bragg_bohr(sym)
    deg = np.full(len(r), degree, dtype=int)
    if degree <= 17:
        return deg
    deg[r < 0.25 * rb] = 13
    deg[(r >= 0.25 * rb) & (r < 0.5 * rb)] = 17 if degree >= 23 else degree
    deg[r > 6.0 * rb] = max(17, degree - 12)
    return deg


def becke(coords, atoms, owner, radii):
    """Becke partition weight of each point for its own atom."""
    natm = atoms.shape[0]
    eye = torch.eye(natm, dtype=torch.bool, device=coords.device)
    d = torch.linalg.norm(coords[:, None, :] - atoms[None], dim=-1)
    rab = torch.linalg.norm(atoms[:, None, :] - atoms[None], dim=-1)
    rab = torch.where(eye, 1.0, rab)
    chi = radii[:, None] / radii[None, :]
    u = (chi - 1.0) / (chi + 1.0)
    a = torch.clamp(u / (u * u - 1.0), -0.5, 0.5)
    mu = (d[:, :, None] - d[:, None, :]) / rab[None]
    p = mu + a[None] * (1.0 - mu * mu)
    for _ in range(3):
        p = 0.5 * p * (3.0 - p * p)
    s = torch.where(eye[None], 1.0, 0.5 * (1.0 - p))
    cell = torch.prod(s, dim=2)
    return torch.gather(cell, 1, owner[:, None])[:, 0] / cell.sum(1)


def build(mol, level: int, device):
    """-> (coords (ngrid, 3), weights (ngrid,)) float64 on `device`."""
    nrad, degs = LEVELS[level]
    cs, ws, own = [], [], []
    for ia, sym in enumerate(mol.symbols):
        per = period(sym)
        r, wr = radial(nrad[per], sym)
        dg = prune(sym, r, degs[per])
        for deg in np.unique(dg):
            m = dg == deg
            pts, wa = lebedev(int(deg))
            c = r[m][:, None, None] * pts[None] + mol.coords[ia]
            cs.append(c.reshape(-1, 3))
            ws.append((wr[m][:, None] * wa[None]).ravel())
            own.append(np.full(m.sum() * len(wa), ia))
    coords = torch.as_tensor(np.concatenate(cs), device=device)
    w = torch.as_tensor(np.concatenate(ws), device=device)
    owner = torch.as_tensor(np.concatenate(own), device=device)
    if len(mol.symbols) > 1:
        atoms = torch.as_tensor(mol.coords, device=device)
        radii = torch.as_tensor([bragg_bohr(s) for s in mol.symbols],
                                dtype=torch.float64, device=device)
        chunk = max(1024, min(65536, 2 ** 27 // len(mol.symbols) ** 2))
        w = w * torch.cat([becke(coords[i:i + chunk], atoms,
                                 owner[i:i + chunk], radii)
                           for i in range(0, len(w), chunk)])
    return coords, w
