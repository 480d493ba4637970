"""High-level restricted Kohn-Sham API of the port.

Port of ``quantum_compute_dft_tpu/kohn_sham.py``: basis, one- and
two-electron integrals, grid and AO planes are built by this package
(torch f64 on the given device), then the SCF runs.  ERIs are in-core up
to AUTO_DF_NAO and density-fitted by pivoted Cholesky above it.  The entry
points run on the GPU unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.basis.basis_set import sad_occupations
from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao
from quantum_compute_dft_tpu_torch.grids import Grid, build_grid
from quantum_compute_dft_tpu_torch.integrals import eri_full, one_electron
from quantum_compute_dft_tpu_torch.integrals.cholesky import (
    cholesky_eri_vectors,
)
from quantum_compute_dft_tpu_torch.mol import Molecule
from quantum_compute_dft_tpu_torch.scf.driver import (
    SCFResult,
    SCFSystem,
    make_system,
    scf_host,
)
from quantum_compute_dft_tpu_torch.xc.functionals import FUNCTIONALS, Functional

# in-core ERIs below/at this nao, density fitting above (see prepare)
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
    # seconds of build_time spent in the Cholesky factorization (DF only)
    df_time: float = 0.0


def _device(device) -> torch.device:
    """The device to run on; the default, cuda, needs a GPU (the CPU runs
    only when asked for, as the CLI's --device cpu)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} (the default is 'cuda') needs a CUDA "
            "GPU; pass device='cpu' to run on the CPU")
    return dev


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
    density_fit: bool | None = None,
    df_aux: str = "parity",
    device="cuda",
) -> KSSetup:
    """Basis, integrals, grid and AO planes on `device`.

    density_fit=None auto-selects: in-core ERIs up to nao AUTO_DF_NAO,
    pivoted-Cholesky density fitting above (tol 1e-7: elementwise ERI
    error <= 1e-7 by construction).  df_aux='parity' (the Cholesky factor)
    is the only factorization ported; the RI auxiliary tiers 'tight' and
    'fast' raise NotImplementedError."""
    device = _device(device)
    t0 = time.time()
    fn = _functional(functional)
    basis = build_basis(mol)
    s, t, v = one_electron(basis, mol.coords, mol.charges, device=device)
    if density_fit is None:
        density_fit = basis.nao > AUTO_DF_NAO
    eri = l_vec = None
    df_time = 0.0
    if density_fit:
        if df_aux != "parity":
            raise NotImplementedError(
                f"df_aux={df_aux!r}: the RI auxiliary-basis tiers ('tight', "
                "'fast') are not ported yet; use df_aux='parity' (the "
                "pivoted-Cholesky factor)")
        t_df = time.time()
        l_vec = cholesky_eri_vectors(basis, device=device)
        df_time = time.time() - t_df
    else:
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
        nopen=mol.nopen, device=device, df_l=l_vec,
        build_k=fn.hyb_coeff != 0.0,
    )
    return KSSetup(sys=sys, functional=fn, nao=basis.nao, ngrid=grid.ngrid,
                   nocc=mol.nocc, build_time=time.time() - t0, grid=grid,
                   df_time=df_time)


def setup_from_arrays(hcore, s, eri, ao, ao_grad, weights, e_nuc, nocc,
                      nopen, sad_occ, functional: str | Functional,
                      device="cuda") -> KSSetup:
    """A setup from precomputed numpy arrays (e.g. the JAX package's
    KSSetup arrays), so the SCF can be compared apart from the setup."""
    device = _device(device)
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
    density_fit: bool | None = None,
    device="cuda",
    **kwargs,
) -> SCFResult:
    setup = prepare(mol, functional, grid_level=grid_level,
                    density_fit=density_fit, device=device)
    return scf_host(setup.sys, setup.functional, callback=callback,
                    xc_impl=xc_impl, **kwargs)
