"""Port integrals against the JAX package and literature anchors.

Tolerances: S/T/V and the ERIs 1e-12 absolute (both packages evaluate the
same McMurchie-Davidson recursion in f64; only the summation order of the
quartet contraction differs); Boys 1e-14 relative (same branches and
table; erf/exp may differ by an ulp); the H2 literature values to the
4 printed digits of Szabo-Ostlund (2e-4) and the RHF energy to 1e-5.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.linalg import eigh

from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.integrals import boys as jax_boys
from quantum_compute_dft_tpu.integrals import eri_full as jax_eri_full
from quantum_compute_dft_tpu.integrals import one_electron as jax_one_electron
from quantum_compute_dft_tpu.integrals.boys import boys_fast as jax_boys_fast
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.integrals import (
    boys,
    boys_fast,
    eri_full,
    one_electron,
)
from quantum_compute_dft_tpu_torch.mol import from_xyz_file, from_xyz_text

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2 = "H 0 0 0\nH 0 0 0.74084823"  # 1.4 bohr


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


@pytest.fixture(scope="module", params=["H2O", "H2Se"])
def both(request):
    """(port basis, port molecule, JAX basis, JAX molecule); H2Se has d
    shells and so exercises the cartesian->spherical contraction."""
    mol = from_xyz_file(_xyz(request.param))
    jmol = jax_from_xyz_file(_xyz(request.param))
    return build_basis(mol), mol, jax_build_basis(jmol), jmol


def test_boys_matches_jax():
    xs = np.concatenate([np.array([0.0, 1e-15, 11.999, 12.0, 12.001]),
                         np.logspace(-6, 6, 80),
                         np.random.default_rng(0).uniform(0, 30, 200)])
    for fn, jfn in ((boys, jax_boys), (boys_fast, jax_boys_fast)):
        ours = fn(12, torch.tensor(xs)).numpy()
        ref = np.asarray(jfn(12, jnp.asarray(xs)))
        np.testing.assert_allclose(ours, ref, rtol=1e-14, atol=0)


def test_one_electron_matches_jax(both):
    bas, mol, jbas, jmol = both
    ours = one_electron(bas, mol.coords, mol.charges)
    ref = jax_one_electron(jbas, jmol.coords, jmol.charges)
    for a, b in zip(ours, ref):
        assert np.abs(a - np.asarray(b)).max() < 1e-12


def test_eri_matches_jax(both):
    bas, _, jbas, _ = both
    ours = eri_full(bas).numpy()
    ref = np.asarray(jax_eri_full(jbas))
    assert ours.shape == ref.shape == (bas.nao,) * 4
    assert np.abs(ours - ref).max() < 1e-12


def _rhf(mol):
    bas = build_basis(mol)
    S, T, V = one_electron(bas, mol.coords, mol.charges)
    eri = eri_full(bas).numpy()
    H = T + V
    nocc = mol.nocc
    _, C = eigh(H, S)
    D = 2 * C[:, :nocc] @ C[:, :nocc].T
    E_old = 0.0
    for _ in range(100):
        J = np.einsum("ijkl,kl->ij", eri, D)
        K = np.einsum("ikjl,kl->ij", eri, D)
        F = H + J - 0.5 * K
        _, C = eigh(F, S)
        D = 2 * C[:, :nocc] @ C[:, :nocc].T
        E = np.sum(D * (H + 0.5 * (J - 0.5 * K))) + mol.energy_nuc()
        if abs(E - E_old) < 1e-11:
            break
        E_old = E
    return E


def test_h2_literature_anchors():
    mol = from_xyz_text(H2)
    bas = build_basis(mol)
    S, T, _ = one_electron(bas, mol.coords, mol.charges)
    assert abs(S[0, 1] - 0.6593) < 2e-4
    assert abs(T[0, 0] - 0.7600) < 2e-4
    assert abs(T[0, 1] - 0.2365) < 2e-4
    eri = eri_full(bas).numpy()
    assert abs(eri[0, 0, 0, 0] - 0.7746) < 2e-4
    assert abs(eri[0, 0, 1, 1] - 0.5697) < 2e-4
    assert abs(eri[0, 1, 0, 1] - 0.2970) < 2e-4
    assert abs(eri[0, 0, 0, 1] - 0.4441) < 2e-4
    assert abs(_rhf(mol) - (-1.116714)) < 1e-5
