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
    two_electron,
)
from quantum_compute_dft_tpu_torch.integrals.mcmurchie import hermite_combos
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


# --- the quartet stage's entry points against the per-block loops they
# replaced (the eager tiles of _quartet_kernel over the gathered pair list,
# as eri_packed and the Cholesky ran them); on the CPU both are the plain
# version, so they agree to 1e-14 relative (bitwise, as run here).  H2O has
# s and p shells (L = 2); H2Se's d shells make L = 4, on every 6th pair to
# keep the CPU time down.  Blocks of 8 leave a ragged last block.


def _old_loop(entry, rows, cols, block, p_all, P_all, et_all, cw, l_pair):
    sel_t = torch.as_tensor(rows)
    p_s, P_s, et_s, cw_s = (p_all[sel_t], P_all[sel_t], et_all[sel_t],
                            cw[sel_t])
    n = len(rows)
    if entry == "diagonal":
        run_diag = two_electron.diag_runner(l_pair, "cpu")
        return torch.cat([
            run_diag(p_s[s:s + block], P_s[s:s + block], et_s[s:s + block],
                     cw_s[s:s + block])
            for s in range(0, n, block)])
    quartet = two_electron._quartet_kernel(l_pair, "cpu")
    if entry == "panel":
        pt = torch.as_tensor(cols)
        pb, Pb, eb, cb = p_s[pt], P_s[pt], et_s[pt], cw_s[pt]
        return torch.cat([
            quartet(p_s[s:s + block], P_s[s:s + block], et_s[s:s + block],
                    cw_s[s:s + block], pb, Pb, eb, cb)
            for s in range(0, n, block)])
    W = torch.zeros((n, n), dtype=torch.float64)
    for sa in range(0, n, block):
        ea = min(sa + block, n)
        for sb in range(sa, n, block):
            eb = min(sb + block, n)
            blk = quartet(p_s[sa:ea], P_s[sa:ea], et_s[sa:ea], cw_s[sa:ea],
                          p_s[sb:eb], P_s[sb:eb], et_s[sb:eb], cw_s[sb:eb])
            W[sa:ea, sb:eb] = blk
            if sb != sa:
                W[sb:eb, sa:ea] = blk.T
    return W


@pytest.mark.parametrize("entry", ["panel", "diagonal", "matrix"])
@pytest.mark.parametrize("name,stride", [("H2O", 1), ("H2Se", 6)])
def test_quartet_entry_points_match_the_block_loop(name, stride, entry):
    bas = build_basis(from_xyz_file(_xyz(name)))
    l_pair = 2 * int(bas.cart_powers.max())
    iu, _, *hermite = two_electron.pair_data(bas)
    pairs = two_electron.quartet_pairs(*hermite, l_pair)
    rows = np.arange(0, len(iu), stride)
    assert len(rows) % 8 and pairs.table is None
    # a pivot list as the Cholesky hands it: positions in `rows`
    piv = np.random.default_rng(3).choice(len(rows), 11, replace=False)
    before = two_electron.LAUNCHES["K4"]
    if entry == "panel":
        new = two_electron.eri_columns(pairs, rows, rows[piv], 8)
    elif entry == "diagonal":
        new = two_electron.eri_diagonal(pairs, rows, 8)
    else:
        new = two_electron.eri_matrix(pairs, rows, 8)
    old = _old_loop(entry, rows, piv, 8, *hermite, l_pair)
    assert two_electron.LAUNCHES["K4"] == before
    assert new.shape == old.shape and new.dtype == torch.float64
    assert (new - old).abs().max() <= 1e-14 * old.abs().max()
    if entry == "matrix":
        # the plain diagonal tiles are computed whole, not mirrored
        assert (new - new.T).abs().max() <= 1e-14 * new.abs().max()
        assert torch.allclose(torch.diagonal(new),
                              two_electron.eri_diagonal(pairs, rows, 8),
                              rtol=1e-14, atol=0)


@pytest.mark.parametrize("l_pair,nc,flops", [(0, 1, 50), (2, 10, 417),
                                             (4, 35, 3744)])
def test_k4_operation_count(l_pair, nc, flops):
    """K4's stated f64 operations a primitive quartet, which set its bound
    in chip_smoke.py (the csrc/eri_quartet.cu note quotes them)."""
    assert len(hermite_combos(l_pair)) == nc
    assert two_electron.k4_flops(l_pair) == flops
