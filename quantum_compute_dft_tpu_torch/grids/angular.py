"""Angular (Lebedev) quadrature via scipy, plus the level tables.

scipy.integrate.lebedev_rule provides the standard Lebedev-Laikov grids;
weights sum to 4*pi.
"""

from __future__ import annotations

import numpy as np
from scipy.integrate import lebedev_rule

# Available Lebedev degrees (scipy supports the standard set).
LEBEDEV_DEGREES = (3, 5, 7, 9, 11, 13, 15, 17, 19, 21, 23, 25, 27, 29, 31,
                   35, 41, 47, 53, 59, 65, 71, 77, 83, 89, 95, 101)

_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def lebedev(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (points (n,3) unit sphere, weights summing to 4 pi)."""
    if degree not in _CACHE:
        deg = min(d for d in LEBEDEV_DEGREES if d >= degree)
        x, w = lebedev_rule(deg)
        _CACHE[degree] = (np.ascontiguousarray(x.T), w)
    return _CACHE[degree]


def npoints(degree: int) -> int:
    return lebedev(degree)[0].shape[0]


# grid level -> (radial points, angular degree) per period, indexed by
# period-1 (H-He, Li-Ne, Na-Ar, K-Kr, Rb-Xe).  Comparable density to the
# reference's PySCF level-3 default (H2 level 3 ~ 2e4 points pruned,
# ref grid.py:33-36 + grid_txt/h2_grid.txt).
LEVELS = {
    0: ((25, 35, 40, 45, 50), (13, 15, 15, 15, 15)),
    1: ((35, 45, 50, 55, 60), (17, 19, 19, 19, 19)),
    2: ((45, 55, 65, 70, 75), (23, 25, 25, 25, 25)),
    3: ((55, 70, 80, 90, 95), (29, 29, 35, 35, 35)),
    4: ((65, 80, 95, 105, 110), (35, 35, 41, 41, 41)),
    5: ((80, 95, 110, 120, 125), (41, 41, 47, 47, 47)),
    6: ((90, 110, 125, 135, 140), (47, 47, 53, 53, 53)),
    7: ((100, 125, 140, 150, 155), (53, 53, 59, 59, 59)),
    8: ((115, 140, 155, 165, 170), (59, 59, 65, 65, 65)),
    9: ((130, 155, 170, 180, 185), (65, 65, 71, 71, 71)),
}


def period_of(z: int) -> int:
    if z <= 2:
        return 1
    if z <= 10:
        return 2
    if z <= 18:
        return 3
    if z <= 36:
        return 4
    return 5
