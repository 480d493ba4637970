"""Port grids and AO evaluation against the JAX package (H2O, grid 1).

Tolerance 1e-12 absolute: the same quadrature, Becke partition and AO
formulas in f64; only library rounding differs.
"""

import os

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.engine.ao_eval import eval_ao as jax_eval_ao
from quantum_compute_dft_tpu.grids import build_grid as jax_build_grid
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao
from quantum_compute_dft_tpu_torch.grids import build_grid
from quantum_compute_dft_tpu_torch.mol import from_xyz_file

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XYZ = os.path.join(ROOT, "molecules", "H2O.xyz")


@pytest.fixture(scope="module")
def grids():
    return (build_grid(from_xyz_file(XYZ), level=1),
            jax_build_grid(jax_from_xyz_file(XYZ), level=1))


def test_build_grid_matches_jax(grids):
    ours, ref = grids
    assert ours.ngrid == ref.ngrid > 1000
    np.testing.assert_array_equal(ours.atom_idx, ref.atom_idx)
    assert np.abs(ours.coords - ref.coords).max() < 1e-12
    assert np.abs(ours.weights - ref.weights).max() < 1e-12


@pytest.mark.parametrize("deriv", [0, 1])
def test_eval_ao_matches_jax(grids, deriv):
    ours_g, _ = grids
    bas = build_basis(from_xyz_file(XYZ))
    jbas = jax_build_basis(jax_from_xyz_file(XYZ))
    ours = eval_ao(bas, ours_g.coords, deriv=deriv)
    ref = jax_eval_ao(jbas, ours_g.coords, deriv=deriv)
    if deriv == 0:
        ours, ref = (ours,), (ref,)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float64
        assert tuple(a.shape) == np.asarray(b).shape
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-12
