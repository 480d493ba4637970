"""The port's CUDA kernels on the card: K1/K2, K3 (phi_split) and the K1
variants (ablations, split2 row sums) against their plain PyTorch
versions, determinism and launch counting, in-core (H2O) and above npad 64
(Decane npad 72, DHA npad 152).  Imports no JAX, so it also runs where JAX
is absent:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Skips without a CUDA GPU.  Tolerance: relative dE 1e-5 and max dV 1e-5
(kernel and plain version are both f32 with a different summation order);
K3's max dV 5e-5 (tensor-core sums); the ablations' max dV 5e-5 of
max(1, max |V|), since an ablated V reaches 1e10 (nofunc), and 2e-3 of it
for noprod: its rho = sum phi_D cancels to near zero at some points, where
the B3LYP potentials amplify the f32 rounding of that sum (measured 1.5e-5
of max |V| at H2O grid 1, 6.3e-4 at DHA grid 3 in chip_smoke.py).
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


def _check_kernel(fn, dm, aot, wt, grads, n, **variant):
    names = fused_xc.launch_names(fn, **variant)
    before = {k: fused_xc.LAUNCHES[k] for k in names}
    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n,
                                           **variant)
    torch.cuda.synchronize()
    assert all(fused_xc.LAUNCHES[k] == before[k] + 2 for k in names)
    assert torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * max(abs(float(e_p)), 1.0)
    tol_v = 1e-5
    if variant.get("ablate"):
        tol_v = (2e-3 if variant["ablate"] == "noprod" else 5e-5) * max(
            1.0, float(torch.abs(v_p).max()))
    elif variant.get("phi_split"):
        tol_v = 5e-5
    assert float(torch.abs(v_k - v_p).max()) < tol_v
    if variant.get("ablate") == "nov":
        assert not v_k.any()


# (functional, variant keywords): K3 and split2 in both bodies, the
# ablations in the GGA body
VARIANT_CASES = (
    [(f, {"phi_split": True}) for f in ("LDA", "B3LYP")]
    + [(f, {"reduce": "split2"}) for f in ("LDA", "B3LYP")]
    + [("PBE", {"phi_split": True, "reduce": "split2"})]
    + [("B3LYP", {"ablate": a}) for a in fused_xc.ABLATIONS])


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


def _dha_planes(fn, dev):
    """DHA (npad 152), every 4th point of the grid-1 grid, a perturbed SAD
    density."""
    mol = from_xyz_file(os.path.join(ROOT, "molecules", "DHA.xyz"))
    basis = build_basis(mol)
    grid = build_grid(mol, level=1, device=dev)
    coords, w = grid.coords[::4], torch.tensor(grid.weights[::4], device=dev)
    ao, grad = eval_ao(basis, coords, deriv=1, device=dev)
    n = basis.nao
    pert = np.random.default_rng(19).standard_normal((n, n)) * 1e-2
    dm = torch.tensor(np.diag(sad_occupations(basis, mol.charges, mol.nelec))
                      + pert + pert.T, device=dev)
    aot, wt, grads = fused_xc.pack_inputs(ao, w, grad,
                                          needs_grad=fn.needs_grad)
    return dm, aot, wt, grads, n


@pytest.mark.parametrize("molecule", ["H2O", "DHA"])
@pytest.mark.parametrize("name,variant", VARIANT_CASES,
                         ids=[f"{f}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for f, kw in VARIANT_CASES])
def test_cuda_variant_matches_plain_version(molecule, name, variant):
    dev = _cuda()
    fn = FUNCTIONALS["GGA" if name == "PBE" else name]
    if molecule == "DHA":
        _check_kernel(fn, *_dha_planes(fn, dev), **variant)
        return
    setup = kohn_sham.prepare(
        from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz")), fn,
        grid_level=1, device=dev)
    s, n = setup.sys, setup.nao
    pert = np.random.default_rng(13).standard_normal((n, n)) * 1e-2
    dm = initial_guess(s) + torch.tensor(pert + pert.T, device=dev)
    aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                          needs_grad=fn.needs_grad)
    _check_kernel(fn, dm, aot, wt, grads, n, **variant)
