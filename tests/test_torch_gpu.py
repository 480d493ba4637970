"""The port's CUDA kernels on the card: K1/K2 against their plain PyTorch
version, determinism and launch counting, in-core (H2O) and above npad 64
(Decane npad 72, DHA npad 152).  Imports no JAX, so it also runs where JAX
is absent:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Skips without a CUDA GPU.  Tolerance: relative dE 1e-5 and max dV 1e-5
(kernel and plain version are both f32 with a different summation order).
"""

import os

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.basis.basis_set import sad_occupations
from quantum_compute_dft_tpu_torch.engine import fused_xc
from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao
from quantum_compute_dft_tpu_torch.grids import build_grid
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.driver import initial_guess
from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check_kernel(fn, dm, aot, wt, grads, n):
    kid = "K1" if fn.needs_grad else "K2"
    before = fused_xc.LAUNCHES[kid]
    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
    e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n)
    torch.cuda.synchronize()
    assert fused_xc.LAUNCHES[kid] == before + 2
    assert torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * max(abs(float(e_p)), 1.0)
    assert float(torch.abs(v_k - v_p).max()) < 1e-5


@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP", "HF"])
def test_cuda_kernel_matches_plain_version(name):
    dev = _cuda()
    setup = kohn_sham.prepare(
        from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz")), name,
        grid_level=1, device=dev)
    s, fn = setup.sys, setup.functional
    n = setup.nao
    pert = np.random.default_rng(13).standard_normal((n, n)) * 1e-2
    dm = initial_guess(s) + torch.tensor(pert + pert.T, device=dev)
    aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                          needs_grad=fn.needs_grad)
    _check_kernel(fn, dm, aot, wt, grads, n)


@pytest.mark.parametrize("molecule,npad", [("Decane", 72), ("DHA", 152)])
@pytest.mark.parametrize("name", ["LDA", "B3LYP"])
def test_cuda_kernel_above_npad_64(molecule, npad, name):
    """Every 4th point of the grid-1 grid, a perturbed SAD density."""
    dev = _cuda()
    mol = from_xyz_file(os.path.join(ROOT, "molecules", molecule + ".xyz"))
    basis = build_basis(mol)
    grid = build_grid(mol, level=1, device=dev)
    fn = FUNCTIONALS[name]
    coords, w = grid.coords[::4], torch.tensor(grid.weights[::4], device=dev)
    if fn.needs_grad:
        ao, grad = eval_ao(basis, coords, deriv=1, device=dev)
    else:
        ao, grad = eval_ao(basis, coords, deriv=0, device=dev), None
    n = basis.nao
    pert = np.random.default_rng(19).standard_normal((n, n)) * 1e-2
    dm = torch.tensor(np.diag(sad_occupations(basis, mol.charges, mol.nelec))
                      + pert + pert.T, device=dev)
    aot, wt, grads = fused_xc.pack_inputs(ao, w, grad,
                                          needs_grad=fn.needs_grad)
    assert aot.shape[0] == npad
    _check_kernel(fn, dm, aot, wt, grads, n)
