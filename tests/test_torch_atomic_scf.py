"""The port's basis generators against the JAX package's: the atomic HF
solver and zeta optimizer (basis/atomic_scf.py) and the STO-nG fit
(basis/stong_fit.py).

Tolerances: atomic energies 1e-10 Eh (the same f64 algebra on integrals
that agree to 1e-12; the SCF stops at |dE| < 1e-10); the optimized zetas
1e-8 relative (the optimizer's choices are discrete, so equal energies
make equal decisions and the zetas agree to rounding); the STO-nG fit to
1e-10 (the same numpy/scipy code on the same inputs), and to the
published 1s expansion as tests/test_basis.py holds the JAX package's.
"""

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.basis import atomic_scf as jax_atomic
from quantum_compute_dft_tpu.basis import stong_fit as jax_stong
from quantum_compute_dft_tpu_torch.basis import UNIVERSAL_FITS, atomic_scf
from quantum_compute_dft_tpu_torch.basis import stong_fit
from quantum_compute_dft_tpu_torch.mol.elements import SYMBOLS

torch.set_num_threads(1)


def test_ground_config_and_channels_equal_jax():
    for z in range(1, 55):
        sym = SYMBOLS[z]
        assert atomic_scf.ground_config(z) == jax_atomic.ground_config(z)
        assert (atomic_scf._channel_occupations(sym)
                == jax_atomic._channel_occupations(sym)), sym
    # Hund filling of Cu's 4s electron (the docstring's example)
    occ_a, occ_b = atomic_scf._channel_occupations("Cu")
    assert occ_a == {0: [1, 1, 1, 1], 1: [1, 1], 2: [1]}
    assert occ_b == {0: [1, 1, 1, 0], 1: [1, 1], 2: [1]}


@pytest.mark.parametrize("sym", ["H", "O", "Na", "Cu"])
def test_atomic_energy_equals_jax(sym):
    e = atomic_scf.atomic_energy(sym, device="cpu")
    e_jax = jax_atomic.atomic_energy(sym)
    assert abs(e - e_jax) < 1e-10, (sym, e, e_jax)


def test_trial_zetas_and_the_scf_density():
    zt = {"1s": 7.5, "2sp": 2.3}
    e, d = atomic_scf.atomic_energy("O", zt, return_scf=True, device="cpu")
    assert abs(e - jax_atomic.atomic_energy("O", zt)) < 1e-10
    # the loop on the integrals' own tensors is the same loop
    basis, h, s, eri = atomic_scf.atom_integrals("O", zt, device="cpu")
    assert atomic_scf.atomic_scf(basis, h, s, eri, "O")[0] == e
    # the density holds the atom's 8 electrons: tr(D S) = 8
    assert abs(float(torch.sum(d * s)) - 8.0) < 1e-10


def test_optimize_zetas_one_sweep_equals_jax():
    zetas, e = atomic_scf.optimize_zetas("O", sweeps=1, device="cpu")
    zetas_j, e_j = jax_atomic.optimize_zetas("O", sweeps=1)
    assert zetas.keys() == zetas_j.keys()
    for sh in zetas:
        assert abs(zetas[sh] / zetas_j[sh] - 1.0) < 1e-8, (sh, zetas, zetas_j)
    assert abs(e - e_j) < 1e-10
    # the optimizer moved both shells downhill from the table
    assert e < atomic_scf.atomic_energy("O", device="cpu") - 1e-4


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        atomic_scf.atomic_energy("H")
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        atomic_scf.optimize_zetas("H", sweeps=1)


def test_fit_shell_equals_jax_and_the_published_1s():
    alphas, coeff_sets, score = stong_fit.fit_shell([(1, 0)], (2.0, 0.4, 0.1))
    a_j, c_j, s_j = jax_stong.fit_shell([(1, 0)], (2.0, 0.4, 0.1))
    assert np.allclose(alphas, a_j, rtol=1e-10, atol=0)
    assert np.allclose(coeff_sets[0], c_j[0], rtol=0, atol=1e-10)
    assert abs(score - s_j) < 1e-12
    # tests/test_basis.py's bar on the JAX package's generator
    assert np.allclose(alphas, UNIVERSAL_FITS["1s"][0], rtol=2e-5)
    assert np.allclose(coeff_sets[0], UNIVERSAL_FITS["1s"][1][0], atol=2e-6)
