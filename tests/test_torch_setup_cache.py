"""The port's setup cache (setup_cache.py) at kohn_sham.prepare's four
points: the key against the JAX package's, cold against warm prepares,
the off switch and a corrupt file.  Every test points DFT_SETUP_CACHE_DIR
at its own tmp_path.

Tolerances: keys equal (the same sha256 over the same bytes); the arrays of
a warm prepare equal the cold one's exactly (.npy stores the float64 bytes),
and so the SCF energies, checked at 1e-12 Eh.
"""

import os

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu import setup_cache as jax_setup_cache
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu_torch import kohn_sham, setup_cache
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.driver import scf_host

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DFT_SETUP_CACHE", "1")
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("name", ["H2O", "H2Se"])
def test_key_matches_jax(name):
    mol = from_xyz_file(_xyz(name))
    jmol = jax_from_xyz_file(_xyz(name))
    key = setup_cache.molecule_basis_key(mol, build_basis(mol))
    assert key == jax_setup_cache.molecule_basis_key(jmol,
                                                      jax_build_basis(jmol))


def _arrays(setup):
    s = setup.sys
    out = {"hcore": s.hcore, "s": s.s, "ao": s.ao, "weights": s.weights}
    for name in ("eri", "df_bq", "ao_grad"):
        if getattr(s, name) is not None:
            out[name] = getattr(s, name)
    return out


@pytest.mark.parametrize("density_fit,hits", [
    (False, {"int1e", "eri", "grid"}), (True, {"int1e", "cdvec", "grid"})])
def test_cold_and_warm_prepare_agree(cache_dir, density_fit, hits):
    mol = from_xyz_file(_xyz("H2O"))
    cold = kohn_sham.prepare(mol, "B3LYP", grid_level=1,
                             density_fit=density_fit, device="cpu")
    warm = kohn_sham.prepare(mol, "B3LYP", grid_level=1,
                             density_fit=density_fit, device="cpu")
    assert cold.cache_hits == () and set(warm.cache_hits) == hits
    assert (cold.df_time > 0.0) == density_fit and warm.df_time == 0.0
    a, b = _arrays(cold), _arrays(warm)
    assert a.keys() == b.keys()
    for name in a:
        assert torch.equal(a[name], b[name]), name
    r0 = scf_host(cold.sys, cold.functional)
    r1 = scf_host(warm.sys, warm.functional)
    assert r0.converged and r1.converged
    assert abs(r1.e_tot - r0.e_tot) < 1e-12


def test_grid_key_carries_level_and_pruning(cache_dir):
    mol = from_xyz_file(_xyz("H2O"))
    kohn_sham.prepare(mol, "LDA", grid_level=1, device="cpu")
    other = kohn_sham.prepare(mol, "LDA", grid_level=1, prune=False,
                              device="cpu")
    assert "grid" not in other.cache_hits and "int1e" in other.cache_hits
    assert len(list(cache_dir.glob("grid_*_L1_p*.npy"))) == 2


def test_off_switch_writes_nothing(cache_dir, monkeypatch):
    monkeypatch.setenv("DFT_SETUP_CACHE", "0")
    mol = from_xyz_file(_xyz("H2O"))
    for _ in range(2):
        setup = kohn_sham.prepare(mol, "LDA", grid_level=1, device="cpu")
        assert setup.cache_hits == ()
    assert list(cache_dir.iterdir()) == []


def test_corrupt_file_is_a_miss(cache_dir):
    mol = from_xyz_file(_xyz("H2O"))
    cold = kohn_sham.prepare(mol, "LDA", grid_level=1, device="cpu")
    (path,) = cache_dir.glob("int1e_*.npy")
    path.write_bytes(b"not an npy file")
    warm = kohn_sham.prepare(mol, "LDA", grid_level=1, device="cpu")
    assert "int1e" not in warm.cache_hits and "grid" in warm.cache_hits
    assert torch.equal(warm.sys.hcore, cold.sys.hcore)
    key = path.stem.split("_", 1)[1]
    (s,) = setup_cache.load("int1e", key, ("s",))   # rewritten by the miss
    assert s.shape == (7, 7)


def test_store_leaves_no_partial_files(cache_dir):
    setup_cache.store("int1e", "k", s=np.eye(2))
    assert [p.name for p in cache_dir.iterdir()] == ["int1e_k.npy"]
    (got,) = setup_cache.load("int1e", "k", ("s",))
    assert np.array_equal(got, np.eye(2))
    assert setup_cache.load("int1e", "missing", ("s",)) is None
