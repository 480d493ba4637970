"""The yardstick: the card's published peaks, the fused XC kernel's least
time, and the device's busy time in a profile.

Copied from the program's tools so that a change to the program cannot
move them: ``xc_bound`` from ``tools/torch_kernel_timing.py`` and
``busy_spans`` from ``utils/profiling.busy_seconds``.
"""

from __future__ import annotations

# H100 SXM data sheet, 700 W: HBM bytes/s and the TF32 tensor-core rate
HBM_BYTES_S = 3.35e12
TF32_FLOP_S = 495e12


def xc_bound_ms(needs_grad: bool, n: int, npts: int) -> float:
    """Least time of one fused XC call (K1 for needs_grad, else K2) on n
    AOs and npts points: the larger of the bytes (the f64 density read,
    the f32 AO plane and, for K1, its three gradient planes and the f32
    weights read once; the f64 V and E written once) at HBM_BYTES_S and
    the products (phi_D = D AO, 2 n^2 npts; V a syr2k of 2 n^2 npts for
    K1, a syrk of n (n + 1) npts for K2) at the TF32 rate."""
    planes = 4 if needs_grad else 1
    nbytes = 8 * (2 * n * n + 1) + 4 * (planes * n + 1) * npts
    flops = 2.0 * n * n * npts + (
        2.0 * n * n if needs_grad else n * (n + 1.0)) * npts
    return 1e3 * max(nbytes / HBM_BYTES_S, flops / TF32_FLOP_S)


def union_seconds(spans, lo=float("-inf"), hi=float("inf")) -> float:
    """Length of the union of (start, end) spans (any unit, returned in
    the same), clipped to [lo, hi]: overlapping spans count once."""
    total, end = 0.0, float("-inf")
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in spans):
        if e <= s:
            continue
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(spans, lo: float, hi: float):
    """The idle intervals of [lo, hi] between the union of the spans."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if e <= cur or s >= hi:
            continue
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
