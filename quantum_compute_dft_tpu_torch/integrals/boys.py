"""Boys function F_m(x) = int_0^1 t^{2m} exp(-x t^2) dt in torch f64.

Port of ``quantum_compute_dft_tpu/integrals/boys.py`` (same branches, same
table, same constants):

  * x < 12:  the all-positive-term series at the highest order, then the
    stable downward recursion F_{m-1} = (2x F_m + exp(-x)) / (2m - 1);
  * x >= 12: F_0(x) = 1/2 sqrt(pi/x) erf(sqrt(x)), then the upward
    recursion F_{m+1} = ((2m+1) F_m - exp(-x)) / (2x).

``boys_fast`` replaces the series by a 7-term Taylor expansion around the
nodes of a host-precomputed table (the hot path of the ERI quartets).
"""

from __future__ import annotations

from math import pi, sqrt

import numpy as np
import torch

_SWITCH = 12.0
_NSERIES = 110  # terms: at x=12 the positive series needs ~80 for 1e-17 tail


def _boys_small(mmax: int, x: torch.Tensor) -> torch.Tensor:
    """Highest order via positive series, valid for x <= _SWITCH."""
    acc = torch.zeros_like(x)
    for k in range(_NSERIES, 0, -1):
        acc = (1.0 + acc) * (2.0 * x) / (2 * mmax + 2 * k + 1)
    acc = (1.0 + acc) / (2 * mmax + 1)
    return torch.exp(-x) * acc


_TABLE_CACHE: dict[int, np.ndarray] = {}
_TABLE_DX = 0.0625       # grid spacing; 7-term Taylor -> ~1e-14 truncation
_TABLE_XMAX = 12.0
_TABLE_TERMS = 7


def _taylor_table(mmax: int) -> np.ndarray:
    """Host-precomputed F_m(x_i) for the Taylor expansion (numpy/scipy)."""
    if mmax not in _TABLE_CACHE:
        from math import gamma as _gamma

        from scipy.special import gammainc as _gammainc

        xs = np.arange(0.0, _TABLE_XMAX + _TABLE_DX * 1.5, _TABLE_DX)
        morders = mmax + _TABLE_TERMS
        tab = np.empty((morders + 1, len(xs)))
        small = xs < 1e-12
        for m in range(morders + 1):
            tab[m, small] = 1.0 / (2 * m + 1)
            xl = xs[~small]
            tab[m, ~small] = (
                _gamma(m + 0.5) * _gammainc(m + 0.5, xl)
                / (2.0 * xl ** (m + 0.5))
            )
        _TABLE_CACHE[mmax] = tab
    return _TABLE_CACHE[mmax]


def _large_branch(mmax: int, x: torch.Tensor) -> list[torch.Tensor]:
    xl = torch.clamp(x, min=_TABLE_XMAX)
    sx = torch.sqrt(xl)
    large = [0.5 * sqrt(pi) / sx * torch.special.erf(sx)]
    emxl = torch.exp(-xl)
    for m in range(mmax):
        large.append(((2 * m + 1) * large[-1] - emxl) / (2.0 * xl))
    return large


def boys_fast(mmax: int, x: torch.Tensor) -> torch.Tensor:
    """Table-driven Boys function, ~1e-13 accurate; returns shape
    (mmax+1,) + x.shape."""
    tab = torch.as_tensor(_taylor_table(mmax), dtype=x.dtype, device=x.device)
    xs = torch.clamp(x, max=_TABLE_XMAX)
    idx = torch.round(xs / _TABLE_DX).to(torch.int64)
    x_i = idx.to(x.dtype) * _TABLE_DX
    dx = x_i - xs
    cols = tab[:, idx]                      # (mmax+TERMS+1, ...) gather
    top = cols[mmax + _TABLE_TERMS]
    for k in range(_TABLE_TERMS - 1, -1, -1):
        top = cols[mmax + k] + top * dx / (k + 1)
    emxs = torch.exp(-xs)
    small = [top]
    for m in range(mmax, 0, -1):
        small.append((2.0 * xs * small[-1] + emxs) / (2 * m - 1))
    small = small[::-1]
    large = _large_branch(mmax, x)
    cond = x < _TABLE_XMAX
    return torch.stack([torch.where(cond, s, l) for s, l in zip(small, large)])


def boys(mmax: int, x: torch.Tensor) -> torch.Tensor:
    """All orders 0..mmax of F_m(x); returns shape (mmax+1,) + x.shape."""
    xs = torch.clamp(x, max=_SWITCH)  # keep unused lanes finite
    emxs = torch.exp(-xs)
    small = [_boys_small(mmax, xs)]
    for m in range(mmax, 0, -1):
        small.append((2.0 * xs * small[-1] + emxs) / (2 * m - 1))
    small = small[::-1]
    large = _large_branch(mmax, x)
    cond = x < _SWITCH
    return torch.stack([torch.where(cond, s, l) for s, l in zip(small, large)])
