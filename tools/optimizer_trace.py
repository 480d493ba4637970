"""optimize_zetas with every trial energy recorded, for either package.

Both packages' basis/atomic_scf.optimize_zetas reach atomic_energy through
their module's global name; optimize_traced swaps that name for a wrapper
for the length of one call.  Used by tools/atomic_reference.py (the JAX
package on the CPU) and chip_smoke.py (the port on the card), so that a
run elsewhere can find the first evaluation at which it parts from the
reference.  Imports nothing of either package.
"""

from __future__ import annotations


def optimize_traced(atomic_scf, symbol: str, **kw):
    """atomic_scf.optimize_zetas(symbol, **kw) -> (zetas, energy, trace),
    trace = [[zetas, energy], ...] of every atomic_energy call, in order.
    Raises if the optimizer made no call through the module's name."""
    energy, trace = atomic_scf.atomic_energy, []

    def traced(sym, zetas=None, **k):
        e = energy(sym, zetas, **k)
        trace.append([dict(zetas), e])
        return e

    atomic_scf.atomic_energy = traced
    try:
        zetas, e = atomic_scf.optimize_zetas(symbol, **kw)
    finally:
        atomic_scf.atomic_energy = energy
    if not trace:
        raise RuntimeError(f"optimize_zetas({symbol!r}) made no call through "
                           f"{atomic_scf.__name__}.atomic_energy: nothing "
                           "was traced")
    return zetas, e, trace
