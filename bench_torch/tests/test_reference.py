"""The plain reference at period 3 and on its pair-packed J/K.

On the CPU at grid level 1: the reference's P and S basis numbers against
the program's table and the published S 1s exponents; its period-3 grid
against the program's build_grid for H2S; J and K from the pair-packed
ERI matrix against a dense einsum over the unpacked tensor (H2O, H2S);
H2O's energies against the values of the dense (nao)^4 route that the
packed one replaced; and H2S's and PH3's energies against the port's
in-core f64 SCF.  The tests may import the program; the reference may not.

    python -m pytest -q bench_torch/tests/test_reference.py
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_torch import harness  # noqa: E402
from bench_torch.reference import basis, grid, integrals, rks  # noqa: E402

H2O = os.path.join(ROOT, "bench_torch", "molecules", "H2O.xyz")
H2S = os.path.join(ROOT, "molecules", "H2S.xyz")
# H2O at grid level 1 on the dense (nao)^4 route before the packed one
# replaced it (the reference's own SCF, 1e-10 Eh)
H2O_DENSE = {"LDA": -74.73991504311971, "B3LYP": -75.32008086655948}
# the port's SCF converged as far as the reference's (1e-10 Eh and a
# commutator below 1e-7): at its default 1e-8 Eh PH3/B3LYP stops 2.3e-8 Eh
# away from its own minimum
TIGHT = ["--conv-tol-e", "1e-11", "--conv-tol-d", "1e-9"]


def reference_mol(path: str) -> basis.Mol:
    return basis.mol_from_angstrom(*harness.read_xyz(path))


@pytest.fixture(scope="module")
def ph3(tmp_path_factory) -> str:
    """PH3 with P-H 1.42 Angstrom and H-P-H 93.3 degrees, as an .xyz."""
    r, cos = 1.42, np.cos(np.deg2rad(93.3))
    s2 = (1.0 - cos) / 1.5                  # so that u_i . u_j = cos
    z, s = np.sqrt(1.0 - s2), np.sqrt(s2)
    rows = [("P", 0.0, 0.0, 0.0)] + [
        ("H", r * s * np.cos(t), r * s * np.sin(t), -r * z)
        for t in (0.0, 2 * np.pi / 3, 4 * np.pi / 3)]
    path = tmp_path_factory.mktemp("ph3") / "PH3.xyz"
    harness.write_xyz(str(path), [a for a, *_ in rows],
                      np.array([xyz for _, *xyz in rows]))
    return str(path)


@pytest.mark.parametrize("sym", ["P", "S"])
def test_period3_basis_is_the_programs(sym):
    """Exponents and coefficients of each shell against the program's
    STO-3G table, 1e-5 relative."""
    from quantum_compute_dft_tpu_torch.basis import data

    z = basis.Z_OF[sym]
    assert list(basis._ZETA[sym]) == data.shells_for_z(z)
    for sh, name in zip(basis.shells(basis.mol_from_angstrom(
            [sym, "H", "H"], np.eye(3))), basis._ZETA[sym]):
        ua, cs = data.UNIVERSAL_FITS[name]
        zeta = data.ZETA[sym][name][0]
        np.testing.assert_allclose(sh.alphas, np.array(ua) * zeta ** 2,
                                   rtol=1e-5)
        _, ref_cs = basis._FITS[name]
        np.testing.assert_allclose(basis._ZETA[sym][name], zeta, rtol=1e-5)
        assert set(ref_cs) == set(cs)
        for lq in cs:
            np.testing.assert_allclose(ref_cs[lq], cs[lq], rtol=1e-5)
    assert basis.BRAGG_ANGSTROM[sym] == 1.00


def test_sulfur_1s_is_the_published_one():
    sh = basis.shells(basis.mol_from_angstrom(["S", "H", "H"], np.eye(3)))[0]
    np.testing.assert_allclose(sh.alphas, [533.13, 97.110, 26.282],
                               rtol=5e-5)


def test_other_elements_raise_a_clear_error():
    with pytest.raises(ValueError, match="Cl"):
        basis.mol_from_angstrom(["Cl", "H"], np.eye(3)[:2])


def test_period3_grid_is_the_programs():
    """H2S at level 1: the same points and weights as build_grid."""
    from quantum_compute_dft_tpu_torch.grids.builder import build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file

    coords, w = grid.build(reference_mol(H2S), 1, "cpu")
    g = build_grid(from_xyz_file(H2S), level=1, prune=True, device="cpu")
    assert coords.shape == (len(g.weights), 3)
    assert np.abs(coords.numpy() - np.asarray(g.coords)).max() < 1e-12
    assert np.abs(w.numpy() - np.asarray(g.weights)).max() < 1e-12


@pytest.mark.parametrize("path", [H2O, H2S], ids=["H2O", "H2S"])
def test_packed_jk_is_the_dense_contraction(path):
    """J and K of a seeded symmetric density from the packed matrix
    against einsums over the tensor unpacked from it.  The packed matrix
    is symmetric, so no element was left unwritten, and the same with one
    bra pair a chunk."""
    ref = rks.Reference(reference_mol(path), 1, "cpu")
    ref.k_rows = 2                       # K in more than one block
    n, g = ref.nao, ref.eri
    assert torch.equal(g, g.T)
    one = integrals.eri_packed(integrals.pair_classes(ref.shells, "cpu"), n,
                               "cpu", budget=1)
    assert torch.equal(one, one.T)
    assert (one - g).abs().max() < 1e-14 * g.abs().max()
    full = g[ref.pair_of.reshape(-1)][:, ref.pair_of.reshape(-1)].view(
        n, n, n, n)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((n, n), generator=gen, dtype=torch.float64)
    dm = x + x.T
    j, k = ref.jk(dm, True)
    j_dense = torch.einsum("ijkl,kl->ij", full, dm)
    k_dense = torch.einsum("ijkl,jl->ik", full, dm)
    assert (j - j_dense).abs().max() < 1e-12 * j_dense.abs().max()
    assert (k - k_dense).abs().max() < 1e-12 * k_dense.abs().max()
    assert ref.jk(dm, False)[1] is None


@pytest.mark.parametrize("name", sorted(H2O_DENSE))
def test_h2o_energy_is_the_dense_routes(name):
    e = rks.Reference(reference_mol(H2O), 1, "cpu").energy(name)
    assert abs(e - H2O_DENSE[name]) < 1e-10


@pytest.fixture(scope="module")
def port_energies(ph3):
    """{(molecule, functional): the port's in-core f64 SCF energy}."""
    from quantum_compute_dft_tpu_torch import cli

    out = {}
    before = os.environ.get("DFT_SETUP_CACHE")
    os.environ["DFT_SETUP_CACHE"] = "0"
    try:
        for label, path in (("H2S", H2S), ("PH3", ph3)):
            for name in ("LDA", "B3LYP"):
                with contextlib.redirect_stdout(io.StringIO()):
                    _, res, _ = cli.run([name, path, "--grid-level", "1",
                                         "--xc-impl", "f64", "--density-fit",
                                         "off", "--device", "cpu", *TIGHT])
                assert res.converged
                out[label, name] = res.e_tot
    finally:
        if before is None:
            os.environ.pop("DFT_SETUP_CACHE")
        else:
            os.environ["DFT_SETUP_CACHE"] = before
    return out


@pytest.mark.parametrize("name", ["LDA", "B3LYP"])
@pytest.mark.parametrize("label", ["H2S", "PH3"])
def test_period3_energy_is_the_ports(port_energies, ph3, monkeypatch,
                                     label, name):
    """Within 1e-8 Eh of the port's in-core f64 SCF on the program's own
    3sp fit; the published fit, which the reference keeps, moves the
    energy by its 8-digit rounding in the program's table alone (~5e-8 Eh
    at H2S)."""
    from quantum_compute_dft_tpu_torch.basis import data

    mol = reference_mol(H2S if label == "H2S" else ph3)
    published = rks.Reference(mol, 1, "cpu").energy(name)
    monkeypatch.setitem(basis._FITS, "3sp", data.UNIVERSAL_FITS["3sp"])
    e = rks.Reference(mol, 1, "cpu").energy(name)
    assert abs(e - port_energies[label, name]) < 1e-8
    assert abs(published - e) < 1e-7
