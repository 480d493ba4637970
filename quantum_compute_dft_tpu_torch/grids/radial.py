"""Radial quadrature for atom-centered molecular grids.

Treutler-Ahlrichs M4 mapping (Treutler & Ahlrichs, JCP 102, 346 (1995))
over Gauss-Chebyshev (2nd kind) nodes -- the same family PySCF's
``gen_grid`` uses by default, replacing the reference's delegated grid
build (ref grid.py:33-39).
"""

from __future__ import annotations

import numpy as np

# Treutler-Ahlrichs xi scale parameters per element (their Table 1);
# elements beyond the table fall back to 1.0.
_XI = {
    "H": 0.8, "He": 0.9,
    "Li": 1.8, "Be": 1.4, "B": 1.3, "C": 1.1, "N": 0.9, "O": 0.9,
    "F": 0.9, "Ne": 0.9,
    "Na": 1.4, "Mg": 1.3, "Al": 1.3, "Si": 1.2, "P": 1.1, "S": 1.0,
    "Cl": 1.0, "Ar": 1.0,
    "K": 1.5, "Ca": 1.4, "Sc": 1.3, "Ti": 1.2, "V": 1.2, "Cr": 1.2,
    "Mn": 1.2, "Fe": 1.2, "Co": 1.2, "Ni": 1.1, "Cu": 1.1, "Zn": 1.1,
    "Ga": 1.1, "Ge": 1.0, "As": 0.9, "Se": 0.9, "Br": 0.9, "Kr": 0.9,
}


def treutler_ahlrichs(n: int, symbol: str) -> tuple[np.ndarray, np.ndarray]:
    """n radial points -> (r, w) with w including the r^2 volume factor.

    M4 mapping: r = (xi/ln 2) (1+x)^0.6 ln(2/(1-x)) over Chebyshev-2 nodes.
    """
    xi = _XI.get(symbol, 1.0)
    i = np.arange(1, n + 1)
    t = i * np.pi / (n + 1)
    x = np.cos(t)                       # (-1, 1)
    w_cheb = np.pi / (n + 1) * np.sin(t) ** 2  # Chebyshev-2 weight
    # strip the Chebyshev weight function sqrt(1-x^2):
    dx = w_cheb / np.sqrt(1.0 - x**2)

    ln2 = np.log(2.0)
    op = (1.0 + x) ** 0.6
    lg = np.log(2.0 / (1.0 - x))
    r = xi / ln2 * op * lg
    drdx = xi / ln2 * op * (0.6 * lg / (1.0 + x) + 1.0 / (1.0 - x))
    w = dx * drdx * r * r
    order = np.argsort(r)
    return r[order], w[order]
