"""FON-RKS smearing, ADIIS, the damped-mixing mixer, the annealing ladder
and the CLI's smearing flags of the port against the JAX package.

Tolerances: the Fermi occupations, chemical potential and smeared density
on a seeded DFT-like spectrum, 1e-12 (same f64 formulas; the eigenvectors
enter only through the density); the ADIIS-mixed Fock matrix, 1e-10 of
its entries (300 descent steps whose gradient is closed-form here and
autodiff there); a smeared SCF fed the JAX package's setup arrays against
the JAX scf_host, 1e-9 Eh on the f64 schedule (same arithmetic, |dE| <
1e-8 from the same guess) and 1e-7 Eh on the 'fast' one (plain f32 XC on
the CPU, then f64 verify cycles to the f64 fixed point); the mixers and
the ladder against the CDIIS fixed point, 1e-7 Eh (the JAX package's own
bar, tests/test_scf.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.basis.basis_set import (
    sad_occupations as jax_sad_occupations,
)
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf import diis as jax_diis
from quantum_compute_dft_tpu.scf import driver as jax_driver
from quantum_compute_dft_tpu_torch import cli, kohn_sham
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf import diis, driver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


def _spectrum(kt_seed=7, n=80):
    """tests/test_scf.py's DFT-like spectrum: deep cores at -300 Eh,
    clustered valence around the Fermi level, sparse virtuals; and a
    seeded S^(-1/2)-like x."""
    rng = np.random.default_rng(kt_seed)
    w = np.sort(np.concatenate([
        -300.0 - 50.0 * rng.random(8),
        -20.0 - 5.0 * rng.random(8),
        -2.0 + 2.5 * rng.random(40),
        2.0 + 15.0 * rng.random(24),
    ]))
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    a = rng.standard_normal((n, n)) * 0.1
    s = np.eye(n) + a @ a.T / n
    ws, vs = np.linalg.eigh(s)
    x = (vs / np.sqrt(ws)) @ vs.T
    # F = S^(1/2) (Q w Q^T) S^(1/2): x^T F x has the spectrum w
    s_half = (vs * np.sqrt(ws)) @ vs.T
    f = s_half @ ((q * w) @ q.T) @ s_half
    return x, 0.5 * (f + f.T)


@pytest.mark.parametrize("kt", [0.5, 0.2, 0.1])
def test_fermi_density_matches_jax(kt):
    x, f = _spectrum()
    nelec = 90.0  # Fermi level inside the dense valence block
    w = np.linalg.eigvalsh(x.T @ f @ x)
    mu = driver._fermi_mu(w, nelec, kt)
    mu_j = float(jax_driver._fermi_mu(jnp.asarray(w), nelec, kt))
    assert abs(mu - mu_j) < 1e-12
    occ = driver._fermi_occ(w, mu, kt)
    occ_j = np.asarray(jax_driver._fermi_occ(jnp.asarray(w), mu, kt))
    assert np.abs(occ - occ_j).max() < 1e-12
    assert abs(np.sum(occ) - nelec) < 1e-9
    dm = driver._fermi_density(torch.tensor(x), torch.tensor(f), nelec, kt)
    dm_j = np.asarray(jax_driver._fermi_density(jnp.asarray(x),
                                                jnp.asarray(f), nelec, kt))
    assert np.abs(dm.numpy() - dm_j).max() < 1e-12


@pytest.mark.parametrize("n_updates", [1, 3, 9])
def test_adiis_update_matches_jax(n_updates):
    """A seeded history of n_updates (F, D) pairs (9 wraps the 8 slots);
    the mixed Fock after every insertion within 1e-10."""
    rng = np.random.default_rng(n_updates)
    n = 7
    st, jst = diis.adiis_init(n), jax_diis.adiis_init(n)
    d0 = rng.standard_normal((n, n))
    for _ in range(n_updates):
        f = rng.standard_normal((n, n)) * 5.0
        f = f + f.T
        d = d0 + 0.1 * rng.standard_normal((n, n))
        d = d + d.T
        st, out = diis.adiis_update(st, torch.tensor(f), torch.tensor(d))
        jst, jout = jax_diis.adiis_update(jst, jnp.asarray(f), jnp.asarray(d))
        assert np.abs(out.numpy() - np.asarray(jout)).max() < 1e-10


def _jax_and_port(molecule, functional, level):
    """The JAX package's setup and the port's setup from its arrays."""
    jmol = jax_from_xyz_file(_xyz(molecule))
    js = jax_kohn_sham.prepare(jmol, functional, grid_level=level)
    s = js.sys
    sad = jax_sad_occupations(jax_build_basis(jmol), jmol.charges, jmol.nelec)
    grad = None if s.ao_grad is None else np.asarray(s.ao_grad)
    setup = kohn_sham.setup_from_arrays(
        np.asarray(s.hcore), np.asarray(s.s), np.asarray(s.eri),
        np.asarray(s.ao), grad, np.asarray(s.weights), s.e_nuc, s.nocc,
        s.nopen, sad, functional, device="cpu")
    return js, setup


@pytest.mark.parametrize("molecule,functional,level,kt", [
    ("H2O", "B3LYP", 1, 0.2),
    # CO2 (nao 15) is where the JAX package's TPU window route would
    # engage; on the CPU both packages take the raw eigh route
    ("CO2", "LDA", 0, 0.3)])
def test_smeared_scf_matches_jax(molecule, functional, level, kt):
    js, setup = _jax_and_port(molecule, functional, level)
    ref = jax_driver.scf_host(js.sys, js.functional, smear_kt=kt)
    # the JAX package's GGA potential (jax_potential)
    fn = setup.functional.jax_potential()
    r64 = driver.scf_host(setup.sys, fn, smear_kt=kt)
    assert ref.converged and r64.converged and r64.smear_kt == kt
    assert abs(r64.e_tot - ref.e_tot) < 1e-9
    # a smeared energy is not stationary at the fixed point (the free
    # energy E - kT S is), so a run stopped at ||dD|| < 1e-6 carries an
    # error of first order in its last ||dD|| (H2O B3LYP kT 0.2: the f64
    # run stops at 9.7e-7, 1.9e-6 Eh from the fixed point).  The 'fast'
    # run, whose trajectory is another, is held to the fixed point: the
    # JAX loop converged to ||dD|| < 1e-10
    fixed = jax_driver.scf_host(js.sys, js.functional, smear_kt=kt,
                                conv_tol_d=1e-10)
    rfast = driver.scf_host(setup.sys, fn, smear_kt=kt, xc_impl="fast")
    assert fixed.converged and rfast.converged and rfast.smear_kt == kt
    assert rfast.fast_cycles > 0 and rfast.verify_cycles > 0
    assert abs(rfast.e_tot - fixed.e_tot) < 1e-7


@pytest.fixture(scope="module")
def h2o_b3lyp():
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "B3LYP",
                              grid_level=1, device="cpu")
    ref = driver.scf_host(setup.sys, setup.functional)
    assert ref.converged
    return setup, ref.e_tot


@pytest.mark.parametrize("xc_impl", ["f64", "fast"])
@pytest.mark.parametrize("mixer", ["adiis+cdiis", "mix+cdiis"])
def test_mixers_reach_the_cdiis_fixed_point(h2o_b3lyp, mixer, xc_impl):
    setup, e_cdiis = h2o_b3lyp
    res = driver.scf_host(setup.sys, setup.functional, mixer=mixer,
                          xc_impl=xc_impl)
    assert res.converged
    assert abs(res.e_tot - e_cdiis) < 1e-7


def test_ladder_recovers_the_integer_solution_as_jax():
    """A gapped system comes out of the ladder with integer occupations
    and the direct energy; the port's ladder lands where the JAX
    package's does."""
    js, setup = _jax_and_port("H2O", "LDA", 0)
    direct = driver.scf_host(setup.sys, setup.functional)
    res = driver.scf_host_annealed(setup.sys, setup.functional,
                                   kts=(0.5, 0.2), mixer="adiis+cdiis")
    ref = jax_driver.scf_host_annealed(js.sys, js.functional, kts=(0.5, 0.2),
                                       mixer="adiis+cdiis")
    assert direct.converged and res.converged and ref.converged
    assert res.smear_kt == 0.0 == ref.smear_kt
    assert abs(res.e_tot - direct.e_tot) < 1e-7
    assert abs(res.e_tot - ref.e_tot) < 1e-9


@pytest.mark.parametrize("no_anneal", [False, True])
def test_cli_auto_anneal(capsys, no_anneal):
    """--max-cycle 1 fails every run: the integer attempt, then (unless
    --no-auto-anneal) the ladder's first rung; exit code 2 either way."""
    argv = ["LDA", "H2O", "--molecules-dir", os.path.join(ROOT, "molecules"),
            "--grid-level", "0", "--device", "cpu", "--max-cycle", "1"]
    rc = cli.main(argv + (["--no-auto-anneal"] if no_anneal else []))
    out = capsys.readouterr().out
    assert rc == 2
    assert "SCF did not converge" in out
    msg = "retrying with the FON-RKS annealing ladder"
    assert (msg in out) != no_anneal


def test_cli_smear_kt_passes_through(capsys):
    setup, res, _ = cli.run([
        "LDA", "H2O", "--molecules-dir", os.path.join(ROOT, "molecules"),
        "--grid-level", "1", "--device", "cpu", "--xc-impl", "f64",
        "--smear-kt", "0.2"])
    out = capsys.readouterr().out
    assert res.converged and res.smear_kt == 0.2
    assert "FON smearing : kT = 0.2 Eh" in out
    direct = driver.scf_host(setup.sys, setup.functional, smear_kt=0.2)
    assert res.e_tot == direct.e_tot
