"""Spherically-averaged atomic Hartree-Fock and variational zeta optimization.

Port of the JAX package's ``basis/atomic_scf.py``: the procedure that
derived every 'optimized' zeta in basis/zeta_optimized.py.  The published
STO-3G tables derive each element's Slater exponents by energy
minimization at the atomic SCF level; for Z = 21-54 this module re-runs
that derivation: a fractional-occupation, spherically-averaged,
spin-resolved HF atom solver plus a coordinate-descent optimizer over the
per-shell zetas.

Spherical averaging: the Fock operator of a spherically-symmetrized
density is block-diagonal in (l, m) and m-degenerate, so the SCF solves
one radial subproblem per l channel and replicates over m.  Occupations
are the configuration-averaged f = n_sub / (2l+1) electrons per m.

The integrals come from the port's one_electron and eri_full on `device`
(f64).  atomic_scf runs the SCF loop in f64 torch on its tensors' device;
atomic_energy hands it host copies: the matrices are at most 27 x 27, and
on the card each cycle waits on three small eighs (the loop took 0.07-0.08
s on the host against 0.15-0.18 s on an H100 at Cu, Se and I;
tools/torch_atomic_timing.py).  The arithmetic is the JAX package's:
per-channel generalized eigh on the radial block, damping 0.6/0.4, the
|dE| < conv_tol stop, the same energy expression.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.basis.basis_set import build_basis
from quantum_compute_dft_tpu_torch.basis.data import ZETA, shells_for_z
from quantum_compute_dft_tpu_torch.mol.elements import Z_OF
from quantum_compute_dft_tpu_torch.mol.molecule import Molecule

# aufbau with the d-block anomalies that matter for Z <= 54
_AUFBAU = ["1s", "2s", "2p", "3s", "3p", "4s", "3d", "4p", "5s", "4d", "5p"]
_CAP = {"s": 2, "p": 6, "d": 10}
_ANOMALIES = {  # Z -> {subshell: electrons} overrides
    24: {"4s": 1, "3d": 5},   # Cr
    29: {"4s": 1, "3d": 10},  # Cu
    41: {"5s": 1, "4d": 4},   # Nb
    42: {"5s": 1, "4d": 5},   # Mo
    44: {"5s": 1, "4d": 7},   # Ru
    45: {"5s": 1, "4d": 8},   # Rh
    46: {"5s": 0, "4d": 10},  # Pd
    47: {"5s": 1, "4d": 10},  # Ag
}


def ground_config(z: int) -> dict[str, int]:
    """Neutral-atom electron configuration {subshell: electrons}."""
    cfg: dict[str, int] = {}
    rem = z
    for sub in _AUFBAU:
        take = min(_CAP[sub[-1]], rem)
        if take:
            cfg[sub] = take
        rem -= take
        if rem == 0:
            break
    for sub, n in _ANOMALIES.get(z, {}).items():
        cfg[sub] = n
    return {k: v for k, v in cfg.items() if v > 0}


def _channel_occupations(symbol: str) -> tuple[dict, dict]:
    """Per-spin, per-l-channel radial occupations (electrons per m
    component), lowest radial orbital first, high-spin (Hund) filling:
    Cu -> alpha {0: [1,1,1,1], 1: [1,1], 2: [1]},
          beta  {0: [1,1,1,0], 1: [1,1], 2: [1]}."""
    cfg = ground_config(Z_OF[symbol])
    occ_a: dict[int, list[float]] = {}
    occ_b: dict[int, list[float]] = {}
    for sub in _AUFBAU:  # energetic fill order within each l channel is by n
        if sub not in cfg:
            continue
        l = "spd".index(sub[-1])
        na = min(cfg[sub], 2 * l + 1)
        nb = cfg[sub] - na
        occ_a.setdefault(l, []).append(na / (2 * l + 1))
        occ_b.setdefault(l, []).append(nb / (2 * l + 1))
    return occ_a, occ_b


def atom_integrals(symbol: str, zetas: dict[str, float] | None = None,
                   device="cuda"):
    """-> (basis, hcore, S, ERI) of the neutral atom in the STO-3G basis
    scaled by `zetas` (defaults to the ZETA table); f64 tensors on
    `device`."""
    from quantum_compute_dft_tpu_torch.integrals import eri_full, one_electron
    from quantum_compute_dft_tpu_torch.kohn_sham import _device

    dev = _device(device)
    mol = Molecule(symbols=(symbol,), coords=np.zeros((1, 3)))
    with warnings.catch_warnings():   # every trial basis is non-canonical
        warnings.simplefilter("ignore", RuntimeWarning)
        basis = build_basis(
            mol, zeta_override={symbol: zetas} if zetas else None)
    s, t, v = one_electron(basis, mol.coords, mol.charges, device=dev)
    s = torch.as_tensor(s, device=dev)
    h = torch.as_tensor(t + v, device=dev)
    return basis, h, s, eri_full(basis, device=dev)


def _geigh(f, s):
    """Generalized symmetric eigenproblem f c = s c w (ascending w)."""
    lo = torch.linalg.cholesky(s)
    a = torch.linalg.solve_triangular(lo, f, upper=False)
    a = torch.linalg.solve_triangular(lo, a.mT, upper=False)
    w, v = torch.linalg.eigh(0.5 * (a + a.mT))
    return w, torch.linalg.solve_triangular(lo.mT, v, upper=True)


def atomic_scf(basis, h, s, eri, symbol: str, max_cycle: int = 200,
               conv_tol: float = 1e-10):
    """The spin-resolved (UHF-style) spherically-averaged SCF on the
    tensors' device -> (energy, total density)."""
    dev, n = h.device, h.shape[0]
    # AO bookkeeping: for each l channel, the radial-shell AO offsets; the
    # m component of a radial shell lives at offset + m
    chan: dict[int, list[int]] = {}
    io = 0
    for sh in basis.shells:
        chan.setdefault(sh.l, []).append(io)
        io += 2 * sh.l + 1
    idx = {l: torch.as_tensor(np.add.outer(np.arange(2 * l + 1), starts),
                              device=dev)
           for l, starts in chan.items()}       # (2l+1, nradial)
    occ_a, occ_b = _channel_occupations(symbol)
    eri_j = eri.reshape(n * n, n * n)
    eri_k = eri.permute(0, 2, 1, 3).reshape(n * n, n * n)

    def density(f, occ):
        d = torch.zeros_like(s)
        for l, ix in idx.items():
            focc = occ.get(l)
            if not focc:
                continue
            i0 = ix[0]
            _, c = _geigh(f[i0[:, None], i0[None, :]],
                          s[i0[:, None], i0[None, :]])
            c = c[:, :len(focc)]
            blk = (c * torch.as_tensor(focc, dtype=c.dtype, device=dev)) \
                @ c.mT
            for im in ix:
                d[im[:, None], im[None, :]] = blk
        return d

    def contract(e2, d):
        return (e2 @ d.reshape(-1)).reshape(n, n)

    # spin-resolved: removes the self-interaction the closed-shell
    # functional would put on open shells (one-electron H is exact)
    da = density(h, occ_a)
    db = density(h, occ_b)
    e_old = 0.0
    for _ in range(max_cycle):
        d = da + db
        j = contract(eri_j, d)
        ka = contract(eri_k, da)
        kb = contract(eri_k, db)
        e = float(torch.sum(d * h) + 0.5 * torch.sum(d * j)
                  - 0.5 * torch.sum(da * ka) - 0.5 * torch.sum(db * kb))
        da_new = density(h + j - ka, occ_a)
        db_new = density(h + j - kb, occ_b)
        if abs(e - e_old) < conv_tol:
            da, db = da_new, db_new
            break
        da = 0.6 * da_new + 0.4 * da  # damping: 3d/4s near-degeneracy
        db = 0.6 * db_new + 0.4 * db
        e_old = e
    return e, da + db


def atomic_energy(
    symbol: str,
    zetas: dict[str, float] | None = None,
    return_scf: bool = False,
    max_cycle: int = 200,
    conv_tol: float = 1e-10,
    device="cuda",
):
    """Spherically-averaged fractional-occupation HF energy of the neutral
    atom in the STO-3G basis scaled by `zetas` (defaults to the ZETA
    table).  Integrals on `device`, the SCF loop on the host.
    return_scf -> (energy, density on the host)."""
    basis, h, s, eri = atom_integrals(symbol, zetas, device)
    e, d = atomic_scf(basis, h.cpu(), s.cpu(), eri.cpu(), symbol, max_cycle,
                      conv_tol)
    return (e, d) if return_scf else e


def optimize_zetas(
    symbol: str,
    sweeps: int = 4,
    rel_step: float = 0.03,
    verbose: bool = False,
    frozen_shells: tuple[str, ...] = (),
    device="cuda",
) -> tuple[dict[str, float], float]:
    """Coordinate-descent energy minimization over the element's shell
    zetas; parabolic line search per coordinate.  -> (zetas, energy).

    `frozen_shells` are kept at their table values: metal valence shells
    use molecular conventions that a free-atom minimization would wrongly
    diffuse (cf. Na 3sp: best-atom 0.84 vs published molecular 1.75)."""
    def energy(zt):
        return atomic_energy(symbol, zt, device=device)

    shells = shells_for_z(Z_OF[symbol])
    zetas = {sh: ZETA[symbol][sh][0] for sh in shells}
    free = [sh for sh in shells if sh not in frozen_shells]
    e = energy(zetas)
    if verbose:
        print(f"{symbol}: start E = {e:.6f}  zetas = {zetas}")
    for sweep in range(sweeps):
        step = rel_step / (2.0 ** sweep)
        improved = False
        for sh in free:
            z0 = zetas[sh]
            trials = {}
            for fac in (1.0 - step, 1.0 + step):
                trials[fac] = energy(dict(zetas, **{sh: z0 * fac}))
            em, e0, ep = trials[1.0 - step], e, trials[1.0 + step]
            denom = em - 2.0 * e0 + ep
            if denom > 0:  # convex: parabola vertex, clipped to +-2 steps
                delta = 0.5 * (em - ep) / denom * step
                delta = float(np.clip(delta, -2.0 * step, 2.0 * step))
            else:  # walk downhill one step
                delta = -step if em < ep else step
            z_new = z0 * (1.0 + delta)
            e_new = energy(dict(zetas, **{sh: z_new}))
            # keep the best of the four evaluations
            best = min(
                [(e0, z0), (em, z0 * (1 - step)), (ep, z0 * (1 + step)),
                 (e_new, z_new)]
            )
            if best[0] < e - 1e-12:
                e, zetas[sh] = best[0], best[1]
                improved = True
            if verbose:
                print(f"  {sh}: zeta {z0:.4f} -> {zetas[sh]:.4f}  "
                      f"E = {e:.6f}")
        if not improved:
            break
    return zetas, e
