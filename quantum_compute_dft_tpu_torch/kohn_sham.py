"""High-level restricted Kohn-Sham API of the port.

Port of ``quantum_compute_dft_tpu/kohn_sham.py`` for the in-core path:
basis, one- and two-electron integrals, grid and AO planes are built by
this package (torch f64 on the given device), then the SCF runs.  Above
AUTO_DF_NAO the JAX package switches to density fitting, which this port
does not have yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.basis.basis_set import sad_occupations
from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao
from quantum_compute_dft_tpu_torch.grids import Grid, build_grid
from quantum_compute_dft_tpu_torch.integrals import eri_full, one_electron
from quantum_compute_dft_tpu_torch.mol import Molecule
from quantum_compute_dft_tpu_torch.scf.driver import (
    SCFResult,
    SCFSystem,
    make_system,
    scf_host,
)
from quantum_compute_dft_tpu_torch.xc.functionals import FUNCTIONALS, Functional

# in-core ERIs below/at this nao; the JAX package density-fits above
AUTO_DF_NAO = 64


@dataclasses.dataclass
class KSSetup:
    sys: SCFSystem
    functional: Functional
    nao: int
    ngrid: int
    nocc: int
    build_time: float
    grid: Grid | None = None


def _functional(functional: str | Functional) -> Functional:
    if isinstance(functional, Functional):
        return functional
    return FUNCTIONALS[functional.upper()]


def prepare(
    mol: Molecule,
    functional: str | Functional = "LDA",
    grid_level: int = 3,
    grid: Grid | None = None,
    prune: bool = True,
    device="cpu",
) -> KSSetup:
    """Basis, integrals, grid and AO planes on `device` (in-core ERIs)."""
    t0 = time.time()
    fn = _functional(functional)
    basis = build_basis(mol)
    if basis.nao > AUTO_DF_NAO:
        raise NotImplementedError(
            f"nao={basis.nao} > {AUTO_DF_NAO}: the JAX package switches to "
            "density-fitted J/K here; density fitting comes to the port in a "
            "later PR")
    s, t, v = one_electron(basis, mol.coords, mol.charges, device=device)
    eri = eri_full(basis, device=device)
    if grid is None:
        grid = build_grid(mol, level=grid_level, prune=prune, device=device)
    if fn.needs_grad:
        ao, ao_grad = eval_ao(basis, grid.coords, deriv=1, device=device)
    else:
        ao, ao_grad = eval_ao(basis, grid.coords, deriv=0, device=device), None
    sys = make_system(
        t + v, s, eri, ao, grid.weights, ao_grad, mol.energy_nuc(), mol.nocc,
        sad_occ=sad_occupations(basis, mol.charges, mol.nelec),
        nopen=mol.nopen, device=device,
    )
    return KSSetup(sys=sys, functional=fn, nao=basis.nao, ngrid=grid.ngrid,
                   nocc=mol.nocc, build_time=time.time() - t0, grid=grid)


def setup_from_arrays(hcore, s, eri, ao, ao_grad, weights, e_nuc, nocc,
                      nopen, sad_occ, functional: str | Functional,
                      device="cpu") -> KSSetup:
    """A setup from precomputed numpy arrays (e.g. the JAX package's
    KSSetup arrays), so the SCF can be compared apart from the setup."""
    t0 = time.time()
    fn = _functional(functional)
    sys = make_system(hcore, s, eri, ao, weights,
                      ao_grad if fn.needs_grad else None, e_nuc, nocc,
                      sad_occ=sad_occ, nopen=nopen, device=device)
    ao = np.asarray(ao)
    return KSSetup(sys=sys, functional=fn, nao=ao.shape[1],
                   ngrid=ao.shape[0], nocc=int(nocc),
                   build_time=time.time() - t0)


def run(
    mol: Molecule,
    functional: str | Functional = "LDA",
    grid_level: int = 3,
    callback=None,
    xc_impl: str = "fast",
    device="cpu",
    **kwargs,
) -> SCFResult:
    setup = prepare(mol, functional, grid_level=grid_level, device=device)
    return scf_host(setup.sys, setup.functional, callback=callback,
                    xc_impl=xc_impl, **kwargs)
