"""STO-3G for H, C, N, O, P and S, and the molecule, for the plain
reference.

The published STO-3G (Hehre, Stewart, Pople, JCP 51, 2657 (1969); the 3sp
fit and the exponents of Na to Ar from Hehre, Ditchfield, Stewart and
Pople, JCP 52, 2769 (1970)): each Slater shell is one universal 3-Gaussian
fit scaled by the element's Slater exponent zeta (alpha = alpha_universal
* zeta^2), with the contraction coefficients shared across elements and
applied to normalized primitives.  The numbers are the fits and zetas the
benchmark's configurations state; only s and p shells occur for these
elements, and a 3sp shell is one more "sp" shell.
"""

from __future__ import annotations

import dataclasses
from math import pi

import numpy as np

ANGSTROM_TO_BOHR = 1.0 / 0.52917721092   # CODATA 2010
Z_OF = {"H": 1, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16}

# universal expansions: shell -> (alphas, {l: coefficients})
_FITS = {
    "1s": ((2.227660584, 0.405771156, 0.109818),
           {0: (0.154328967, 0.535328142, 0.444634542)}),
    "2sp": ((0.994203, 0.231031, 0.0751386),
            {0: (-0.09996723, 0.39951283, 0.70011547),
             1: (0.15591627, 0.60768372, 0.39195739)}),
    "3sp": ((0.4828540806, 0.1347150629, 0.05272656258),
            {0: (-0.2196203690, 0.2255954336, 0.9003984260),
             1: (0.01058760429, 0.5951670053, 0.4620010120)}),
}
_ZETA = {"H": {"1s": 1.24},
         "C": {"1s": 5.67, "2sp": 1.72},
         "N": {"1s": 6.67, "2sp": 1.95},
         "O": {"1s": 7.66, "2sp": 2.25},
         "P": {"1s": 14.50, "2sp": 5.31, "3sp": 1.90},
         "S": {"1s": 15.47, "2sp": 5.79, "3sp": 2.05}}

# Bragg-Slater radii (Angstrom; H at the quadrature codes' 0.35)
BRAGG_ANGSTROM = {"H": 0.35, "C": 0.70, "N": 0.65, "O": 0.60, "P": 1.00,
                  "S": 1.00}



@dataclasses.dataclass(frozen=True)
class Mol:
    symbols: tuple
    coords: np.ndarray   # (natm, 3) bohr

    @property
    def charges(self) -> np.ndarray:
        return np.array([Z_OF[s] for s in self.symbols], dtype=np.float64)

    @property
    def nocc(self) -> int:
        nelec = int(self.charges.sum())
        if nelec % 2:
            raise ValueError("the reference is closed-shell only")
        return nelec // 2

    def energy_nuc(self) -> float:
        r = self.coords
        d = np.sqrt(((r[:, None, :] - r[None, :, :]) ** 2).sum(-1))
        iu = np.triu_indices(len(r), 1)
        z = self.charges
        return float((np.outer(z, z)[iu] / d[iu]).sum())


def mol_from_angstrom(symbols, coords_angstrom) -> Mol:
    missing = sorted(set(symbols) - set(Z_OF))
    if missing:
        raise ValueError(f"the reference has STO-3G for {', '.join(Z_OF)} "
                         f"only, not {', '.join(missing)}")
    xyz = np.asarray(coords_angstrom, dtype=np.float64)
    return Mol(tuple(symbols), xyz * ANGSTROM_TO_BOHR)


@dataclasses.dataclass(frozen=True)
class Shell:
    kind: str            # "s" (one function) or "sp" (s, px, py, pz)
    center: np.ndarray   # (3,) bohr
    alphas: np.ndarray   # (3,)
    coeffs: np.ndarray   # (3, ncomp): coefficient of each primitive,
    #                      normalization included, per component


def _norm(l: int, alpha: float) -> float:
    """Norm of x^l exp(-alpha r^2) (one cartesian power l <= 1)."""
    return (2.0 * alpha / pi) ** 0.75 * (4.0 * alpha) ** (l / 2.0)


def shells(mol: Mol) -> list[Shell]:
    """The molecule's shells: 1s as an "s" shell, 2sp and 3sp each as one
    "sp" shell (s and p share their exponents)."""
    out = []
    for sym, xyz in zip(mol.symbols, mol.coords):
        for name, zeta in _ZETA[sym].items():
            ua, cs = _FITS[name]
            a = np.array(ua) * zeta * zeta
            cols = [[c * _norm(0, ai) for c, ai in zip(cs[0], a)]]
            if 1 in cs:
                cp = [c * _norm(1, ai) for c, ai in zip(cs[1], a)]
                cols += [cp, cp, cp]
            out.append(Shell("sp" if 1 in cs else "s", xyz.copy(), a,
                             np.array(cols).T))
    return out


def nao(shell_list) -> int:
    return sum(4 if s.kind == "sp" else 1 for s in shell_list)


def bragg_bohr(sym: str) -> float:
    return BRAGG_ANGSTROM[sym] * ANGSTROM_TO_BOHR

