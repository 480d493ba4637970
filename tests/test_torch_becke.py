"""K6's pair tables (grids/becke.py) on the CPU.

K6 (csrc/becke.cu) runs only on the card.  Here its tables are read as the
kernel reads them (`_read_tables`: per point the distances to every atom,
then for each atom i the product over j != i of s(nu_ij), with
mu_ij = (d_i - d_j) * {1/R_ij}, j ascending)
and held to the plain version (becke_partition on the CPU, the eager chunks
of becke_weights) and to the JAX package's becke_weights: H2O at grid 1,
Benzene and Vitamin-B2 on a seeded slice of their grid-1 points.  Tolerance
1e-12 absolute per weight (weights lie in [0, 1]): all three are f64 with
the same formulas; only the order of the products and the division by R_ij
against the multiplication by its reciprocal differ.  prepare on the CPU
runs the plain version, counts no K6 launch and times the partition.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.grids.becke import becke_weights as jax_becke
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.grids import becke, build_grid, builder
from quantum_compute_dft_tpu_torch.mol import from_xyz_file

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


def _read_tables(tab, coords, owner, atoms):
    """The partition weights from K6's tables, read as the kernel reads
    them."""
    tab = tab.numpy()
    natm = len(atoms)
    d = np.sqrt(sum((coords[:, k, None] - atoms[None, :, k]) ** 2
                    for k in range(3)))
    total = np.zeros(len(coords))
    own = np.zeros(len(coords))
    for i in range(natm):
        p = np.ones(len(coords))
        for j in (*range(i), *range(i + 1, natm)):
            mu = (d[:, i] - d[:, j]) * tab[i, j, 0]
            q = mu + tab[i, j, 1] * (1.0 - mu * mu)
            for _ in range(3):
                q = 0.5 * q * (3.0 - q * q)
            p = p * (0.5 * (1.0 - q))
        total += p
        own = np.where(owner == i, p, own)
    return own / total


@pytest.fixture(scope="module")
def points():
    """name -> (molecule, coords, owners): all of H2O's grid-1 points, a
    seeded 1,500 of Benzene's and Vitamin-B2's (only the points matter, so
    their weights are not computed)."""
    real = builder.becke_partition
    builder.becke_partition = lambda c, *a, **k: np.ones(len(c))
    out = {}
    try:
        for name in ("H2O", "Benzene", "Vitamin-B2"):
            mol = from_xyz_file(_xyz(name))
            g = build_grid(mol, level=1)
            if name != "H2O":
                pick = np.sort(np.random.default_rng(20).choice(
                    g.ngrid, 1500, replace=False))
                g.coords, g.atom_idx = g.coords[pick], g.atom_idx[pick]
            out[name] = (mol, g.coords, g.atom_idx)
    finally:
        builder.becke_partition = real
    return out


@pytest.mark.parametrize("name", ["H2O", "Benzene", "Vitamin-B2"])
def test_tables_read_as_the_plain_version(points, name):
    mol, coords, owner = points[name]
    xyz = torch.as_tensor(mol.coords)
    tab = becke.k6_tables(xyz, torch.as_tensor(mol.bragg_radii()))
    assert tab.dtype == torch.float64 and tab.is_contiguous()
    assert tab.shape == (mol.natm, mol.natm, 2)
    got = _read_tables(tab, coords, owner, mol.coords)
    plain = becke.becke_partition(coords, mol.coords, owner,
                                  mol.bragg_radii())
    ref = np.asarray(jax_becke(jnp.asarray(coords), jnp.asarray(mol.coords),
                               jnp.asarray(owner),
                               jnp.asarray(mol.bragg_radii())))
    assert got.shape == plain.shape == ref.shape == (len(coords),)
    assert 0.0 <= plain.min() and plain.max() <= 1.0
    assert np.abs(got - plain).max() <= 1e-12
    assert np.abs(got - ref).max() <= 1e-12


@pytest.mark.parametrize("name", ["H2O", "Benzene", "Vitamin-B2"])
def test_tables_hold_the_pair_symmetries(points, name):
    """1/R_ij is symmetric and a_ij antisymmetric (to rounding: a_ji comes
    from R_j / R_i), both 1 and 0 on the never-used diagonal, and |a| <=
    0.5 (the clamp)."""
    mol = points[name][0]
    tab = becke.k6_tables(torch.as_tensor(mol.coords),
                          torch.as_tensor(mol.bragg_radii())).numpy()
    rinv, a = tab[..., 0], tab[..., 1]
    assert np.array_equal(rinv, rinv.T)
    assert np.abs(a + a.T).max() <= 1e-15 and np.abs(a).max() <= 0.5
    assert np.all(np.diag(rinv) == 1.0) and np.all(np.diag(a) == 0.0)
    off = ~np.eye(mol.natm, dtype=bool)
    r = np.linalg.norm(mol.coords[:, None] - mol.coords[None], axis=-1)
    assert np.abs(rinv[off] * r[off] - 1.0).max() <= 1e-15


def test_cold_prepare_times_the_plain_partition(tmp_path, monkeypatch):
    """On the CPU prepare's partition is the plain version: no K6 launch,
    setup_split records 0 launches and the partition's seconds; a warm
    cache loads the grid, with 0 launches and no partition."""
    monkeypatch.setenv("DFT_SETUP_CACHE", "1")
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path))
    mol = from_xyz_file(_xyz("H2O"))
    before = becke.LAUNCHES["K6"]
    cold = kohn_sham.prepare(mol, "LDA", grid_level=1, device="cpu")
    warm = kohn_sham.prepare(mol, "LDA", grid_level=1, device="cpu")
    assert becke.LAUNCHES["K6"] == before
    assert "grid" not in cold.cache_hits and "grid" in warm.cache_hits
    assert cold.setup_split["becke_kernel_launches"] == 0
    assert 0.0 < cold.setup_split["becke_s"] <= cold.setup_split["grid_s"]
    assert warm.setup_split["becke_kernel_launches"] == 0
    assert "becke_s" not in warm.setup_split


def test_k6_raises_on_what_it_does_not_take():
    """No fallback: K6's entry raises on CPU tensors; the partition refuses
    an owning atom outside the molecule before it reaches the device."""
    mol = from_xyz_file(_xyz("H2O"))
    xyz = torch.as_tensor(mol.coords)
    tab = becke.k6_tables(xyz, torch.as_tensor(mol.bragg_radii()))
    coords = torch.zeros((4, 3), dtype=torch.float64)
    owner = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="K6"):
        becke._k6(coords, owner, xyz, tab)
    with pytest.raises(ValueError, match="owning atoms 0..2"):
        becke.becke_partition(coords.numpy(), mol.coords, np.full(4, 3),
                              mol.bragg_radii(), device="cuda")
