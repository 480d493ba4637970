"""Molecule container: geometry, electron count, nuclear repulsion.

Replaces the PySCF ``gto.Mole`` roles used by the reference
(ref grid.py:42-66): electron/occupation counting (grid.py:50-52) and
``energy_nuc`` (grid.py:66).  Coordinates are stored in Bohr.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from quantum_compute_dft_tpu_torch.mol.elements import ANGSTROM_TO_BOHR, Z_OF, bragg_bohr
from quantum_compute_dft_tpu_torch.mol import xyz as xyz_mod


@dataclasses.dataclass(frozen=True)
class Molecule:
    symbols: tuple[str, ...]          # element symbols, normalized
    coords: np.ndarray                # (natm, 3) float64, Bohr
    charge: int = 0

    @property
    def natm(self) -> int:
        return len(self.symbols)

    @property
    def charges(self) -> np.ndarray:
        return np.array([Z_OF[s] for s in self.symbols], dtype=np.float64)

    @property
    def nelec(self) -> int:
        return int(self.charges.sum()) - self.charge

    @property
    def nocc(self) -> int:
        """Doubly-occupied orbital count for RKS (ref grid.py:52)."""
        return self.nelec // 2

    @property
    def nopen(self) -> int:
        """Singly-occupied orbital count (0 or 1).

        The reference cannot represent odd-electron systems at all: its
        PySCF build hardcodes spin=0 (ref grid.py:45) and mol.build()
        raises on an odd electron count, so `python dft.py B3LYP CuO`
        crashes before reaching the solver.  Here odd counts run as
        fractional-occupation restricted KS: nelec//2 doubly-occupied
        orbitals plus one singly-occupied HOMO (spin-restricted ensemble
        density; scf.driver._density)."""
        return self.nelec % 2

    def energy_nuc(self) -> float:
        """Nuclear repulsion sum_{i<j} Z_i Z_j / |R_i - R_j| (ref grid.py:66)."""
        z = self.charges
        r = self.coords
        diff = r[:, None, :] - r[None, :, :]
        dist = np.sqrt((diff ** 2).sum(-1))
        zz = np.outer(z, z)
        iu = np.triu_indices(self.natm, k=1)
        return float((zz[iu] / dist[iu]).sum()) if self.natm > 1 else 0.0

    def bragg_radii(self) -> np.ndarray:
        return np.array([bragg_bohr(s) for s in self.symbols])


def from_atoms(
    atoms: list[tuple[str, tuple[float, float, float]]],
    charge: int = 0,
    unit: str = "angstrom",
) -> Molecule:
    syms = tuple(s for s, _ in atoms)
    coords = np.array([c for _, c in atoms], dtype=np.float64)
    if unit.lower().startswith("ang"):
        coords = coords * ANGSTROM_TO_BOHR
    return Molecule(symbols=syms, coords=coords, charge=charge)


def from_xyz_file(path: str, charge: int = 0) -> Molecule:
    return from_atoms(xyz_mod.load_xyz(path), charge=charge)


def from_xyz_text(text: str, charge: int = 0) -> Molecule:
    return from_atoms(xyz_mod.parse_xyz_text(text), charge=charge)
