"""The fused XC kernel's plain PyTorch version against the Pallas kernel
(interpret mode, set up as tests/test_pallas.py does) and the f64 engine.

Tolerances: plain f32 vs the f64 engine, the Pallas contract of
tests/test_pallas.py (relative dE 5e-5, max dV 5e-5).  Plain f32 vs the
Pallas kernel, relative dE 2e-5 and max dV 2e-5: on these inputs the
Pallas kernel itself sits 1.2e-5 (relative E) and 1.4e-5 (V) from the f64
engine -- V from its 3-pass bf16 V product, E from the interpret-mode dot
that sums the bf16 hi and lo parts of w e sequentially in f32 over one
49,152-point tile (ROADMAP, "Reduction precision";
tests/test_torch_xc_variants.py) -- while the plain f32 version sits
below 1e-7 and 1e-6; the bound is the Pallas kernel's own error with
margin.  The same bounds hold at npad 72 on real Decane AO planes.  The
CUDA kernel itself is tested in tests/test_torch_gpu.py.
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


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(px.pl, "pallas_call", patched)


def _inputs(name):
    """JAX setup arrays and a seeded perturbed SAD density, as numpy."""
    setup = jax_kohn_sham.prepare(jax_from_atoms(H2O), name, grid_level=1)
    s = setup.sys
    rng = np.random.default_rng(11)
    pert = rng.standard_normal(s.hcore.shape) * 1e-2
    dm = np.asarray(jax_guess(s)) + pert + pert.T
    grad = None if s.ao_grad is None else np.asarray(s.ao_grad)
    return setup, dm, np.asarray(s.ao), np.asarray(s.weights), grad


def _torch(*arrays, device="cpu"):
    return [None if a is None else torch.tensor(a, device=device)
            for a in arrays]


@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP"])
def test_reference_matches_pallas_and_f64(interpret, name):
    setup, dm, ao, w, grad = _inputs(name)
    e_px, v_px = px.xc_step_pallas(setup.functional, jnp.asarray(dm),
                                   setup.sys.ao, setup.sys.weights,
                                   setup.sys.ao_grad, tile=512)
    fn = FUNCTIONALS[name]
    dm_t, ao_t, w_t, g_t = _torch(dm, ao, w, grad)
    # the Pallas kernel's V_xc has half the sigma term (jax_potential)
    e, v = fused_xc.xc_step_fused(fn.jax_potential(), dm_t, ao_t, w_t, g_t)
    assert e.dtype == v.dtype == torch.float64
    e_px = float(e_px)
    assert abs(float(e) - e_px) < 2e-5 * abs(e_px)
    assert np.abs(v.numpy() - np.asarray(v_px)).max() < 2e-5
    e, v = fused_xc.xc_step_fused(fn, dm_t, ao_t, w_t, g_t)
    e64, v64 = xc_step(fn, dm_t, ao_t, w_t, g_t)
    assert abs(float(e) - float(e64)) < 5e-5 * abs(float(e64))
    assert float(torch.abs(v - v64).max()) < 5e-5


@pytest.fixture(scope="module")
def decane_planes():
    """Real Decane planes (nao 72, npad 72) from the JAX eval_ao on every
    32nd point of the grid-1 grid (4,307 points), and a seeded perturbed
    SAD density, as numpy."""
    mol = jax_from_xyz_file(os.path.join(ROOT, "molecules", "Decane.xyz"))
    basis = jax_build_basis(mol)
    grid = jax_build_grid(mol, level=1)
    ao, grad = jax_eval_ao(basis, grid.coords[::32], deriv=1)
    rng = np.random.default_rng(17)
    pert = rng.standard_normal((basis.nao, basis.nao)) * 1e-2
    dm = np.diag(jax_sad_occupations(basis, mol.charges, mol.nelec)) + \
        pert + pert.T
    return dm, np.asarray(ao), grid.weights[::32], np.asarray(grad)


@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP"])
def test_reference_matches_pallas_above_npad_64(interpret, decane_planes,
                                                name):
    dm, ao, w, grad = decane_planes
    fn = FUNCTIONALS[name]
    grad = grad if fn.needs_grad else None
    assert fused_xc._npad_for(ao.shape[1]) == 72
    e_px, v_px = px.xc_step_pallas(
        JAX_FUNCTIONALS[name], jnp.asarray(dm), jnp.asarray(ao),
        jnp.asarray(w), None if grad is None else jnp.asarray(grad),
        tile=512)
    dm_t, ao_t, w_t, g_t = _torch(dm, ao, w, grad)
    e, v = fused_xc.xc_step_fused(fn.jax_potential(), dm_t, ao_t, w_t, g_t)
    e_px = float(e_px)
    assert abs(float(e) - e_px) < 2e-5 * abs(e_px)
    assert np.abs(v.numpy() - np.asarray(v_px)).max() < 2e-5
    e, v = fused_xc.xc_step_fused(fn, dm_t, ao_t, w_t, g_t)
    e64, v64 = xc_step(fn, dm_t, ao_t, w_t, g_t)
    assert abs(float(e) - float(e64)) < 5e-5 * abs(float(e64))
    assert float(torch.abs(v - v64).max()) < 5e-5


def test_cpu_tensors_take_the_plain_version():
    setup, dm, ao, w, grad = _inputs("GGA")
    fn = FUNCTIONALS["GGA"]
    dm_t, ao_t, w_t, g_t = _torch(dm, ao, w, grad)
    aot, wt, grads = fused_xc.pack_inputs(ao_t, w_t, g_t, needs_grad=True)
    gpad = -(-ao.shape[0] // fused_xc.CHUNK) * fused_xc.CHUNK
    assert aot.shape == (8, gpad) and aot.dtype == torch.float32
    assert float(aot[7].abs().max()) == 0.0     # padded AO row
    assert float(wt[ao.shape[0]:].abs().max()) == 0.0  # padded points
    before = dict(fused_xc.LAUNCHES)
    a = fused_xc.fused_xc(fn, dm_t, aot, wt, grads, dm.shape[0])
    b = fused_xc.fused_xc_reference(fn, dm_t, aot, wt, grads, dm.shape[0])
    assert fused_xc.LAUNCHES == before
    assert float(a[0]) == float(b[0])
    assert torch.equal(a[1], b[1])


def test_kernel_shape_checks():
    fn = FUNCTIONALS["LDA"]
    n = 385
    dm = torch.zeros((n, n), dtype=torch.float64)
    wt = torch.zeros(1024)
    fused_xc._check_inputs(fn, dm[:377, :377], torch.zeros((384, 1024)), wt,
                           None, 377)
    with pytest.raises(ValueError, match="npad <= 384"):
        fused_xc._check_inputs(fn, dm, torch.zeros((392, 1024)), wt, None, n)
    with pytest.raises(ValueError, match="bad shapes"):
        fused_xc._check_inputs(fn, dm[:8, :8], torch.zeros((8, 1000)),
                               torch.zeros(1000), None, 8)
    with pytest.raises(ValueError, match="bad shapes"):
        fused_xc._check_inputs(fn, dm[:6, :6], torch.zeros((6, 1024)), wt,
                               None, 6)


@pytest.mark.parametrize("npad,gpad", [(8, 1024), (40, 138240),
                                       (152, 634880), (384, 65536),
                                       (384, 1150976)])
def test_v_chunk_covers_the_grid_with_bounded_scratch(npad, gpad):
    chunk = fused_xc.v_chunk(npad, gpad)
    nchunk = -(-gpad // chunk)
    ntile = -(-npad // fused_xc.TILE)
    assert chunk % fused_xc.CHUNK == 0 and (nchunk - 1) * chunk < gpad
    # partial buffer nchunk * (64 ntile)^2 f32 stays within V_BLOCKS tiles
    assert nchunk * ntile * ntile <= fused_xc.V_BLOCKS


@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
def test_functional_finite_over_extreme_inputs(name):
    r = np.concatenate([[0.0], 10.0 ** np.linspace(-12, 4, 40)])
    s = np.concatenate([[0.0], 10.0 ** np.linspace(-20, 8, 40)])
    R, S = np.meshgrid(r, s)
    rho = torch.tensor(R.ravel(), dtype=torch.float32)
    sig = torch.tensor(S.ravel(), dtype=torch.float32)
    for arr in fused_xc.functional_eval(FUNCTIONALS[name], rho, sig):
        assert arr.dtype == torch.float32
        assert bool(torch.isfinite(arr).all()), name

