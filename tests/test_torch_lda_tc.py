"""K2's arithmetic (the LDA body on TF32 tensor cores, csrc/fused_xc.cu's
xc_rho_res_kernel / xc_rho_kernel and xc_lda_v_kernel) emulated in torch on
the CPU, and its V tile schedule.

The emulation does what the kernels do, in f32: each operand x splits into
hi = tf32(x) rounded to nearest with ties away (the kernels' bit rounding,
cvt.rna's rule) and lo = x - hi, which the tensor core reads truncated to
tf32; a product is hi.lo + lo.hi + hi.hi with f32 sums.  phi_D^T = AO^T D^T
so rho = sum_mu phi_D AO; s = w vrho; V = AO diag(s) AO^T from its upper
triangle, mirrored.  It lives here, not on the port's path: the CPU path
runs the plain f32 version (engine/fused_xc.py::fused_xc_reference).

Tolerances: against the f64 engine the Pallas contract (relative dE and
max dV 5e-5, tests/test_pallas.py); against the Pallas kernel in interpret
mode 2e-5, the bound of tests/test_torch_fused_xc.py (the Pallas kernel's
own error from its 3-pass bf16 V product and its sequential E sum, with
margin).  The split product itself is held to 2e-6 of the f64 product's
scale (sum |a||b|), where one TF32 pass is off by ten times more.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import quantum_compute_dft_tpu.engine.pallas_xc as px
from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.basis.basis_set import (
    sad_occupations as jax_sad_occupations,
)
from quantum_compute_dft_tpu.engine.ao_eval import eval_ao as jax_eval_ao
from quantum_compute_dft_tpu.grids import build_grid as jax_build_grid
from quantum_compute_dft_tpu.mol import from_atoms as jax_from_atoms
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.driver import initial_guess as jax_guess
from quantum_compute_dft_tpu.xc.functionals import (
    FUNCTIONALS as JAX_FUNCTIONALS,
)
from quantum_compute_dft_tpu_torch.engine import fused_xc
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H2O = [("O", (0.0, 0.0, 0.127)), ("H", (0.0, 0.758, -0.509)),
       ("H", (0.0, -0.758, -0.509))]

_LOW13 = -8192  # 0xffffe000: the bits a tf32 keeps


def _tf32_rna(x):
    """tf32(x) rounded to nearest, ties away: (bits + 0x1000) & ~0x1fff."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & _LOW13).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & _LOW13).view(torch.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


def _mm3(a, b):
    """a @ b as 3 x TF32 with f32 sums, small terms first."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def lda_tc_emulated(functional, dm, aot, wt, n: int):
    """K2 on packed planes, emulated -> (E_xc, V_xc) in dm's dtype."""
    npad = aot.shape[0]
    dm_p = fused_xc._pad_dm(dm, npad)
    phi_t = _mm3(aot.T, dm_p.T)                        # (gpad, npad)
    rho = torch.sum(phi_t * aot.T, dim=1)
    e, vrho, _ = fused_xc.functional_eval_reference(functional, rho)
    exc = torch.sum(wt * e)
    v = _mm3(aot, (wt * vrho * aot).T)                 # (npad, npad)
    v = torch.triu(v) + torch.triu(v, 1).T
    return exc.to(dm.dtype), v[:n, :n].to(dm.dtype)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(px.pl, "pallas_call", patched)


def test_tf32_rounding_is_nearest_ties_away():
    one_ulp = 2.0 ** -10  # a tf32 ulp at 1
    x = torch.tensor([1.0 + one_ulp / 2, -(1.0 + one_ulp / 2),
                      1.0 + one_ulp / 4, 1.0 + 3 * one_ulp / 4, 0.0,
                      3.0 + one_ulp * 1.5], dtype=torch.float32)
    want = [1.0 + one_ulp, -(1.0 + one_ulp), 1.0, 1.0 + one_ulp, 0.0,
            3.0 + 2 * one_ulp]
    assert _tf32_rna(x).tolist() == want


def test_split_is_exact_and_keeps_19_bits():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal(4096) * 10.0 ** rng.uniform(
        -8, 4, 4096), dtype=torch.float32)
    hi, lo = _split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # hi + (x - hi) is x exactly; lo drops at most 2^-11 of x - hi
    x64, hi64, lo64 = x.double(), hi.double(), lo.double()
    assert torch.all(torch.abs(x64 - hi64) <= 2.0 ** -11 * torch.abs(x64))
    assert torch.all(torch.abs(x64 - hi64 - lo64)
                     <= 2.0 ** -22 * torch.abs(x64))


@pytest.mark.parametrize("m,k,n", [(64, 152, 152), (152, 2432, 152),
                                   (40, 8, 40)])
def test_split_product_is_f32_class(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    at, bt = torch.tensor(a), torch.tensor(b)
    err3 = np.abs(_mm3(at, bt).double().numpy() - ref) / scale
    err1 = np.abs((_tf32_rna(at) @ _tf32_rna(bt)).double().numpy() - ref) \
        / scale
    assert err3.max() < 2e-6
    assert err1.max() > 10 * err3.max()  # one TF32 pass is not f32-class


def _h2o_inputs(name):
    setup = jax_kohn_sham.prepare(jax_from_atoms(H2O), name, grid_level=1)
    s = setup.sys
    rng = np.random.default_rng(11)
    pert = rng.standard_normal(s.hcore.shape) * 1e-2
    dm = np.asarray(jax_guess(s)) + pert + pert.T
    return dm, np.asarray(s.ao), np.asarray(s.weights)


@pytest.fixture(scope="module")
def decane_planes():
    """Real Decane planes (nao 72, npad 72) from the JAX eval_ao on every
    32nd point of the grid-1 grid, and a seeded perturbed SAD density (the
    shapes of tests/test_torch_fused_xc.py's fixture)."""
    mol = jax_from_xyz_file(os.path.join(ROOT, "molecules", "Decane.xyz"))
    basis = jax_build_basis(mol)
    grid = jax_build_grid(mol, level=1)
    ao = jax_eval_ao(basis, grid.coords[::32], deriv=0)
    rng = np.random.default_rng(17)
    pert = rng.standard_normal((basis.nao, basis.nao)) * 1e-2
    dm = np.diag(jax_sad_occupations(basis, mol.charges, mol.nelec)) + \
        pert + pert.T
    return dm, np.asarray(ao), np.asarray(grid.weights[::32])


def _check(name, dm, ao, w, pallas=True):
    """The emulation against the f64 engine and (LDA) the Pallas kernel."""
    fn = FUNCTIONALS[name]
    dm_t, ao_t, w_t = (torch.tensor(a) for a in (dm, ao, w))
    aot, wt, _ = fused_xc.pack_inputs(ao_t, w_t)
    e, v = lda_tc_emulated(fn, dm_t, aot, wt, dm.shape[0])
    assert e.dtype == v.dtype == torch.float64
    assert torch.equal(v, v.T)
    e64, v64 = xc_step(fn, dm_t, ao_t, w_t)
    assert abs(float(e) - float(e64)) <= 5e-5 * max(abs(float(e64)), 1.0)
    assert float(torch.abs(v - v64).max()) < 5e-5
    if pallas:
        e_px, v_px = px.xc_step_pallas(
            JAX_FUNCTIONALS[name], jnp.asarray(dm), jnp.asarray(ao),
            jnp.asarray(w), None, tile=512)
        e_px = float(e_px)
        assert abs(float(e) - e_px) < 2e-5 * abs(e_px)
        assert np.abs(v.numpy() - np.asarray(v_px)).max() < 2e-5
    return e, v


@pytest.mark.parametrize("name", ["LDA", "HF"])
def test_lda_body_on_h2o(interpret, name):
    dm, ao, w = _h2o_inputs("LDA")
    e, v = _check(name, dm, ao, w, pallas=name == "LDA")
    if name == "HF":  # the zero functional: no XC energy or potential
        assert float(e) == 0.0 and not v.any()


@pytest.mark.parametrize("name", ["LDA", "HF"])
def test_lda_body_on_decane_planes(interpret, decane_planes, name):
    dm, ao, w = decane_planes
    assert fused_xc._npad_for(ao.shape[1]) == 72
    _check(name, dm, ao, w, pallas=name == "LDA")


def _v_subtiles(r, c, npad):
    """The 16 x 8 (row, col) sub-tiles of V tile (r, c) that its warp
    computes (xc_lda_v_kernel's on[i][j]): inside npad and not wholly below
    the diagonal."""
    tile = fused_xc.LDA_V_TILE
    return [(m0, n0) for m0 in range(r * tile, (r + 1) * tile, 16)
            for n0 in range(c * tile, (c + 1) * tile, 8)
            if m0 < npad and n0 < npad and n0 + 8 > m0]


@pytest.mark.parametrize("npad", [8, 40, 72, 152, 384])
def test_v_schedule_covers_the_upper_triangle_once(npad):
    groups = fused_xc.lda_v_tiles(npad)
    assert all(1 <= len(gr) <= fused_xc.LDA_V_WARPS for gr in groups)
    cover = np.zeros((npad, npad), dtype=np.int64)
    for gr in groups:
        for r, c in gr:
            assert r <= c
            for m0, n0 in _v_subtiles(r, c, npad):
                cover[m0:m0 + 16, n0:n0 + 8] += 1
    upper = np.triu(np.ones((npad, npad), dtype=bool))
    assert (cover[upper] == 1).all()
    assert cover.max() == 1  # no sub-tile is computed twice


@pytest.mark.parametrize("npad", [8, 40, 72, 152, 384])
@pytest.mark.parametrize("gpad", [1024, 65536, 138240, 634880, 1150976])
def test_v_chunk_covers_the_grid_with_bounded_partials(npad, gpad):
    chunk = fused_xc.lda_v_chunk(npad, gpad)
    nchunk = -(-gpad // chunk)
    ldv = -(-npad // fused_xc.LDA_V_TILE) * fused_xc.LDA_V_TILE
    assert chunk % 32 == 0 and (nchunk - 1) * chunk < gpad
    assert nchunk * ldv * ldv <= fused_xc.LDA_V_PART_FLOATS
    assert nchunk * len(fused_xc.lda_v_tiles(npad)) <= fused_xc.LDA_V_BLOCKS
