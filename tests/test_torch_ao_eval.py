"""K5's table (engine/ao_eval.pack_table) on the CPU.

K5 (csrc/ao_eval.cu) runs only on the card.  Here its packed table is read
as the kernel reads it (`_read_table`: per point and AO, the terms in order,
the tail cut, each power a chain of products, the three powers of a term
unpacked from one int) and held to the plain version (eval_ao on the CPU,
the eager chunks of _eval_chunk) and to the JAX package's eval_ao, for
values and gradients: H2O and H2Se (T = 9 terms, powers to 2) at grid 1,
Vitamin-B2 on a seeded slice of its grid-1 points.  Tolerance 1e-12 of the
largest magnitude of each plane: all three are f64 with the same formulas;
only the order of the sums and the exp's last bits differ.
"""

import dataclasses
import os
import warnings

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.engine.ao_eval import eval_ao as jax_eval_ao
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.engine import ao_eval
from quantum_compute_dft_tpu_torch.grids import build_grid, builder
from quantum_compute_dft_tpu_torch.mol import from_xyz_file

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


def _chain(base, p):
    """base ** p by chained products, p an integer array (1 for p = 0)."""
    out = np.ones_like(base)
    for k in range(1, int(p.max(initial=0)) + 1):
        out = np.where(p >= k, out * base, out)
    return out


def _read_table(tab, coords, deriv):
    """The AO planes from K5's packed table, read as the kernel reads it."""
    table, powers = tab.table.numpy(), tab.powers.numpy()
    nterm = powers.shape[0]
    alpha, weight = table[3:3 + nterm], table[3 + nterm:]
    d = [coords[:, k, None] - table[k][None, :] for k in range(3)]
    r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    ao = np.zeros_like(r2)
    grad = np.zeros((3,) + r2.shape)
    for t in range(nterm):
        a, w = alpha[t], weight[t]
        p = (powers[t] & 7, (powers[t] >> 3) & 7, powers[t] >> 6)
        arg = -a * r2
        live = (arg > -85.0) & (w != 0.0)
        e = np.where(live, np.exp(np.where(live, arg, 0.0)), 0.0)
        mono = [_chain(d[k], p[k]) for k in range(3)]
        ao += w * (mono[0] * mono[1] * mono[2]) * e
        for k in range(3 * deriv):
            poly = np.where(p[k] > 0, p[k] * _chain(d[k], np.maximum(
                p[k] - 1, 0)), 0.0)
            f = poly - 2.0 * a * (mono[k] * d[k])
            m, n = (m for m in range(3) if m != k)
            grad[k] += w * (f * (mono[m] * mono[n])) * e
    return (ao, grad) if deriv else ao


def _bases(name):
    with warnings.catch_warnings():  # Se's tables are 'optimized'
        warnings.simplefilter("ignore", RuntimeWarning)
        return (build_basis(from_xyz_file(_xyz(name))),
                jax_build_basis(jax_from_xyz_file(_xyz(name))))


@pytest.fixture(scope="module")
def points():
    """name -> grid-1 coordinates: all of H2O's and H2Se's, a seeded 1,500
    of Vitamin-B2's (only the points matter, so its Becke weights are not
    computed)."""
    out = {n: build_grid(from_xyz_file(_xyz(n)), level=1).coords
           for n in ("H2O", "H2Se")}
    real = builder.becke_partition
    builder.becke_partition = lambda c, *a, **k: np.ones(len(c))
    try:
        vb2 = build_grid(from_xyz_file(_xyz("Vitamin-B2")), level=1).coords
    finally:
        builder.becke_partition = real
    pick = np.random.default_rng(18).choice(len(vb2), 1500, replace=False)
    out["Vitamin-B2"] = vb2[np.sort(pick)]
    return out


@pytest.mark.parametrize("deriv", [0, 1])
@pytest.mark.parametrize("name", ["H2O", "Vitamin-B2", "H2Se"])
def test_packed_table_reads_as_the_plain_version(points, name, deriv):
    basis, jbasis = _bases(name)
    coords = points[name]
    tab = ao_eval.pack_table(basis)
    assert tab.table.dtype == torch.float64 and tab.powers.dtype == torch.int32
    assert tab.table.shape == (3 + 2 * basis.term_alphas.shape[1], basis.nao)
    if name == "H2Se":
        assert tab.powers.shape[0] == 9 and basis.term_powers.max() == 2
    got = _read_table(tab, coords, deriv)
    plain = ao_eval.eval_ao(basis, coords, deriv=deriv)
    ref = jax_eval_ao(jbasis, coords, deriv=deriv)
    if deriv == 0:
        got, plain, ref = (got,), (plain,), (ref,)
    for g, p, r in zip(got, plain, ref):
        p, r = p.numpy(), np.asarray(r)
        assert g.shape == p.shape == r.shape
        scale = np.abs(p).max()
        assert np.abs(g - p).max() <= 1e-12 * scale
        assert np.abs(g - r).max() <= 1e-12 * scale


@pytest.mark.parametrize("name", ["LDA", "B3LYP"])
def test_cpu_runs_the_plain_version(name):
    """On the CPU prepare's AO planes come from the plain version: no K5
    launch, and setup_split records 0."""
    before = ao_eval.LAUNCHES["K5"]
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), name,
                              grid_level=1, device="cpu")
    assert setup.setup_split["ao_kernel_launches"] == 0
    assert ao_eval.LAUNCHES["K5"] == before


@pytest.mark.parametrize("power", [5, -1])
def test_table_check_raises_on_a_power_k5_does_not_take(power):
    basis = build_basis(from_xyz_file(_xyz("H2O")))
    powers = basis.term_powers.copy()
    powers[0, 0, 1] = power
    with pytest.raises(ValueError, match="powers 0..4"):
        ao_eval.pack_table(dataclasses.replace(basis, term_powers=powers))


@pytest.mark.parametrize("deriv", [0, 1, 2])
def test_k5_raises_on_what_it_does_not_take(deriv):
    """No fallback: K5's entry raises on CPU tensors, and on deriv 2."""
    basis = build_basis(from_xyz_file(_xyz("H2O")))
    coords = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="K5"):
        ao_eval._k5(ao_eval.pack_table(basis), coords, deriv)
