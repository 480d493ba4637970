"""K1's arithmetic (the GGA body on TF32 tensor cores: csrc/fused_xc.cu's
xc_rho_res_kernel / xc_rho_kernel and xc_gga_v_kernel) emulated in torch
on the CPU.  Its V schedule lives in the C source only; the card tests
(tests/test_torch_gpu.py) hold the kernel's whole V against the plain
version.

The emulation does what the kernels do, in f32: each product runs as 3 x
TF32 (test_torch_lda_tc.py's split: hi rounded to nearest with ties away,
lo read truncated; hi.lo + lo.hi + hi.hi with f32 sums).  phi_D^T = AO^T
D^T; rho = sum_mu phi_D AO and grad_k rho = 2 sum_mu phi_D dAO_k are folded
from phi_D; sigma = |grad rho|^2; the functional; s = w vrho and u_k = c w
vsigma grad_k rho (c the functional's sigma_factor, 4; 2 under
jax_potential(): the JAX package's V_xc, which the comparison with the
Pallas kernel takes); B = ((s AO + u_0 dAO_0) + u_1
dAO_1) + u_2 dAO_2, each product rounded and the sum taken left to right,
as the V kernel forms it;
V + V^T = AO B^T + B AO^T as two 3 x TF32 products, its upper triangle
mirrored and halved, as the reduce does.  It lives here, not on the port's
path: the CPU path runs the plain f32 version
(engine/fused_xc.py::fused_xc_reference).

Tolerances: against the plain version 1e-6 (relative dE) and 5e-6 (max
dV), both f32 with another summation order; against the f64 engine the
Pallas contract (relative dE and max dV 5e-5, tests/test_pallas.py);
against the Pallas kernel in interpret mode 2e-5, the bound of
tests/test_torch_fused_xc.py (the Pallas kernel's own error from its
3-pass bf16 V product and its sequential E sum, with margin).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_lda_tc import _mm3

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


def gga_tc_emulated(functional, dm, aot, wt, grads, n: int):
    """K1 on packed planes, emulated -> (E_xc, V_xc) in dm's dtype."""
    npad = aot.shape[0]
    dm_p = fused_xc._pad_dm(dm, npad)
    phi_t = _mm3(aot.T, dm_p.T)                         # (gpad, npad)
    rho = torch.sum(phi_t * aot.T, dim=1)
    gr = 2.0 * torch.sum(phi_t[None] * grads.transpose(1, 2), dim=2)
    sigma = torch.sum(gr * gr, dim=0)
    e, vrho, vsigma = fused_xc.functional_eval_reference(functional, rho,
                                                         sigma)
    exc = torch.sum(wt * e)
    s = wt * vrho
    u = (functional.sigma_factor * wt * vsigma) * gr    # (3, gpad)
    b = s * aot
    for k in range(3):
        b = b + u[k] * grads[k]
    v = _mm3(aot, b.T) + _mm3(b, aot.T)                 # V + V^T
    v = 0.5 * (torch.triu(v) + torch.triu(v, 1).T)
    return exc.to(dm.dtype), v[:n, :n].to(dm.dtype)


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(px.pl, "pallas_call", patched)


def _h2o_inputs(name):
    """H2O grid 1 (nao 7, npad 8: ragged) from the JAX setup, and a seeded
    perturbed SAD density, as numpy."""
    setup = jax_kohn_sham.prepare(jax_from_atoms(H2O), name, grid_level=1)
    s = setup.sys
    rng = np.random.default_rng(11)
    pert = rng.standard_normal(s.hcore.shape) * 1e-2
    dm = np.asarray(jax_guess(s)) + pert + pert.T
    return (dm, np.asarray(s.ao), np.asarray(s.weights),
            np.asarray(s.ao_grad))


def _check(name, dm, ao, w, grad, pallas=True):
    """The emulation against the plain version, the f64 engine and the
    Pallas kernel (interpret mode)."""
    fn = FUNCTIONALS[name]
    dm_t, ao_t, w_t, g_t = (torch.tensor(a) for a in (dm, ao, w, grad))
    aot, wt, grads = fused_xc.pack_inputs(ao_t, w_t, g_t, needs_grad=True)
    n = dm.shape[0]
    e, v = gga_tc_emulated(fn, dm_t, aot, wt, grads, n)
    assert e.dtype == v.dtype == torch.float64
    assert torch.equal(v, v.T)
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm_t, aot, wt, grads, n)
    assert abs(float(e) - float(e_p)) <= 1e-6 * abs(float(e_p))
    assert float(torch.abs(v - v_p).max()) < 5e-6
    e64, v64 = xc_step(fn, dm_t, ao_t, w_t, g_t)
    assert abs(float(e) - float(e64)) <= 5e-5 * abs(float(e64))
    assert float(torch.abs(v - v64).max()) < 5e-5
    if pallas:
        e, v = gga_tc_emulated(fn.jax_potential(), dm_t, aot, wt, grads, n)
        e_px, v_px = px.xc_step_pallas(
            JAX_FUNCTIONALS[name], jnp.asarray(dm), jnp.asarray(ao),
            jnp.asarray(w), jnp.asarray(grad), tile=512)
        e_px = float(e_px)
        assert abs(float(e) - e_px) < 2e-5 * abs(e_px)
        assert np.abs(v.numpy() - np.asarray(v_px)).max() < 2e-5


@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
def test_gga_body_on_h2o(interpret, name):
    _check(name, *_h2o_inputs(name))


@pytest.fixture(scope="module")
def decane65_planes():
    """Decane's first 65 AOs (npad 72: ragged above npad 64) with their
    gradients on every 64th point of the grid-1 grid, from the JAX
    eval_ao, and a seeded perturbed SAD density, as numpy."""
    mol = jax_from_xyz_file(os.path.join(ROOT, "molecules", "Decane.xyz"))
    basis = jax_build_basis(mol)
    grid = jax_build_grid(mol, level=1)
    ao, grad = jax_eval_ao(basis, grid.coords[::64], deriv=1)
    rng = np.random.default_rng(29)
    pert = rng.standard_normal((basis.nao, basis.nao)) * 1e-2
    dm = np.diag(jax_sad_occupations(basis, mol.charges, mol.nelec)) + \
        pert + pert.T
    return (dm[:65, :65], np.ascontiguousarray(np.asarray(ao)[:, :65]),
            np.asarray(grid.weights[::64]),
            np.ascontiguousarray(np.asarray(grad)[:, :, :65]))


@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
def test_gga_body_ragged_above_npad_64(decane65_planes, name):
    dm, ao, w, grad = decane65_planes
    assert (ao.shape[1], fused_xc._npad_for(ao.shape[1])) == (65, 72)
    _check(name, dm, ao, w, grad, pallas=False)
