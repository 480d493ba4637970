"""Molecular Becke grid construction (numpy around the torch Becke
partition; a copy of ``quantum_compute_dft_tpu/grids/builder.py`` with the
partition weights computed on the given device).

Native replacement for the reference's two grid paths:
  * ``init_gridpy`` (PySCF gen_grid level 3, the live path,
    ref grid.py:33-39) -> :func:`build_grid`;
  * ``init_grid`` (external 6-column grid file, dead-code path,
    ref grid.py:6-20) -> :func:`load_grid_file`.

A Grid holds host numpy arrays; kohn_sham.prepare moves them to its device
with the AO planes.  The Becke partition runs on the given device (K6 on
CUDA, grids/becke.py), inside the span ``grid.becke``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quantum_compute_dft_tpu_torch.grids.angular import LEVELS, lebedev, period_of
from quantum_compute_dft_tpu_torch.grids.becke import becke_partition
from quantum_compute_dft_tpu_torch.grids.radial import treutler_ahlrichs
from quantum_compute_dft_tpu_torch.mol.elements import Z_OF
from quantum_compute_dft_tpu_torch.mol.molecule import Molecule
from quantum_compute_dft_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class Grid:
    coords: np.ndarray    # (ngrid, 3) bohr
    weights: np.ndarray   # (ngrid,) quadrature * Becke partition weights
    atom_idx: np.ndarray  # (ngrid,) owning atom

    @property
    def ngrid(self) -> int:
        return len(self.weights)


def _prune_degrees(z: int, r: np.ndarray, degree: int) -> np.ndarray:
    """NWChem-style pruning: smaller angular grids near the nucleus.

    Returns per-radial-shell angular degree.
    """
    from quantum_compute_dft_tpu_torch.mol.elements import SYMBOLS, bragg_bohr

    rb = bragg_bohr(SYMBOLS[z])
    deg = np.full(len(r), degree, dtype=int)
    if degree <= 17:
        return deg
    deg[r < 0.25 * rb] = 13
    deg[(r >= 0.25 * rb) & (r < 0.5 * rb)] = 17 if degree >= 23 else degree
    # outermost region also slightly reduced (tail contributes little)
    deg[r > 6.0 * rb] = max(17, degree - 12)
    return deg


def build_grid(mol: Molecule, level: int = 3, prune: bool = True,
               device="cpu", timings: dict | None = None) -> Grid:
    """The molecule's grid at `level`, its Becke partition computed on
    `device`; with `timings`, the partition's host seconds (ending in the
    weights' copy to the host) are added to timings["becke_s"]."""
    coords_list, w_list, idx_list = [], [], []
    nrad_tab, deg_tab = LEVELS[level]
    for ia, sym in enumerate(mol.symbols):
        z = Z_OF[sym]
        per = period_of(z) - 1
        nrad, degree = nrad_tab[per], deg_tab[per]
        r, wr = treutler_ahlrichs(nrad, sym)
        degs = _prune_degrees(z, r, degree) if prune else np.full(len(r), degree)
        for deg in np.unique(degs):
            mask = degs == deg
            pts, wang = lebedev(int(deg))
            # outer product radial shell x angular point
            rr = r[mask]
            ww = wr[mask]
            c = rr[:, None, None] * pts[None, :, :] + mol.coords[ia]
            w = ww[:, None] * wang[None, :]
            coords_list.append(c.reshape(-1, 3))
            w_list.append(w.ravel())
            idx_list.append(np.full(w.size, ia, dtype=np.int32))
    coords = np.concatenate(coords_list)
    w_quad = np.concatenate(w_list)
    atom_idx = np.concatenate(idx_list)

    if mol.natm > 1:
        with span("grid.becke", into=timings, key="becke_s"):
            w_becke = becke_partition(coords, mol.coords, atom_idx,
                                      mol.bragg_radii(), device=device)
        weights = w_quad * w_becke
    else:
        weights = w_quad
    return Grid(coords=coords, weights=weights, atom_idx=atom_idx)



def load_grid_file(path: str) -> Grid:
    """Load the reference's 6-column grid format: atom_idx x y z w w
    (ref grid.py:11-15, grid_txt/h2_grid.txt)."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    return Grid(
        coords=np.ascontiguousarray(data[:, 1:4]),
        weights=np.ascontiguousarray(data[:, 4]),
        atom_idx=data[:, 0].astype(np.int32),
    )
