"""The port's CUDA kernels on the card: K1/K2, K1base (K1 on the
four-kernel pipeline), K3 (phi_split) and the variants (ablations, split2
row sums) against their plain PyTorch versions, determinism and launch
counting, in-core (H2O) and above npad 64 (Decane npad 72, DHA npad 152);
K1 and K2 (the GGA and LDA bodies on TF32 tensor cores) also against the
f64 engine (relative dE and max dV 5e-5, the Pallas contract) at every
shape from H2O to npad 384 (184 and 200 among them), and K3 and phi3 (the bf16 mode of the same
kernels) there against the plain K3 and the f64 engine (3e-4, 3e-3), and
the ablations nophi and nov (K1's kernels with no product, and with no V
kernel) there against their plain versions; K4 (the ERI quartet stage), K5
(the AO planes) and K6 (the Becke partition) against their f64 plain
versions.
Imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Skips without a CUDA GPU.  Tolerance: relative dE 1e-5 and max dV 1e-5
(kernel and plain version are both f32 with a different summation order);
K3's and phi3's max dV 5e-5 (tensor-core sums); the other ablations' max dV 5e-5 of
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
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
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
    torch.cuda.synchronize()  # a fault shows at the kernel that made it
    e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n,
                                           **variant)
    torch.cuda.synchronize()
    assert all(fused_xc.LAUNCHES[k] == before[k] + 2 for k in names)
    assert torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * max(abs(float(e_p)), 1.0)
    tol_v = 1e-5
    if variant.get("phi_split") or variant.get("ablate") == "phi3":
        tol_v = 5e-5
    elif variant.get("ablate"):
        tol_v = (2e-3 if variant["ablate"] == "noprod" else 5e-5) * max(
            1.0, float(torch.abs(v_p).max()))
    assert float(torch.abs(v_k - v_p).max()) < tol_v
    if variant.get("ablate") == "nov":
        assert not v_k.any()


# (functional, variant keywords): K3 and split2 in both bodies, the
# ablations in the GGA body
VARIANT_CASES = (
    [(f, {"phi_split": True}) for f in ("LDA", "B3LYP")]
    + [(f, {"reduce": "split2"}) for f in ("LDA", "B3LYP")]
    + [("PBE", {"phi_split": True, "reduce": "split2"})]
    + [(f, {"base": True}) for f in ("PBE", "B3LYP")]
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


@pytest.mark.parametrize("variant", [{}, {"base": True}, {"phi_split": True}],
                         ids=["K1", "K1base", "K3"])
@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
def test_cuda_gga_body_half_sigma_matches_plain_version(name, variant):
    """The factor of w vsigma reaches both C entries (fused_xc_tc and the
    four-kernel pipeline): under jax_potential() the GGA body gives its plain
    version's V_xc with half the sigma term (the JAX package's), the same
    E bit for bit, and a V_xc that the factor moves."""
    dev = _cuda()
    setup = kohn_sham.prepare(
        from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz")), name,
        grid_level=1, device=dev)
    s, fn = setup.sys, setup.functional
    n = setup.nao
    pert = np.random.default_rng(13).standard_normal((n, n)) * 1e-2
    dm = initial_guess(s) + torch.tensor(pert + pert.T, device=dev)
    aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                          needs_grad=True)
    half = fn.jax_potential()
    e_k, v_k = fused_xc.fused_xc(half, dm, aot, wt, grads, n, **variant)
    torch.cuda.synchronize()
    e_p, v_p = fused_xc.fused_xc_reference(half, dm, aot, wt, grads, n,
                                           **variant)
    e_d, v_d = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    torch.cuda.synchronize()
    tol_v = 5e-5 if variant.get("phi_split") else 1e-5
    assert abs(float(e_k) - float(e_p)) <= 1e-5 * max(abs(float(e_p)), 1.0)
    assert float(torch.abs(v_k - v_p).max()) < tol_v
    assert torch.equal(e_k, e_d)
    assert float(torch.abs(v_k - v_d).max()) > 100 * tol_v


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


def _tc_planes(shape, fn, dev):
    """(dm, ao, w, grad) f64 on the card for one K1/K2 shape (grad None for
    K2): H2O grid 1 at a perturbed guess, else a perturbed SAD density on
    grid-1 points (Decane's first 65 AOs on every 4th point: npad 72,
    ragged; Decane and DHA on every 4th point: npad 72, 152; the first
    65,536 points of C17H31O6N5S: npad 184, and of C33H56N7O17P3S: npad
    384, and its first 197 AOs there: npad 200, ragged.  npad 184 and 200
    take the streaming rho kernel's last half k16 step, from a 24- and an
    8-deep last D slab)."""
    if shape == "H2O":
        setup = kohn_sham.prepare(
            from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz")), fn,
            grid_level=1, device=dev)
        n = setup.nao
        pert = np.random.default_rng(13).standard_normal((n, n)) * 1e-2
        dm = initial_guess(setup.sys) + torch.tensor(pert + pert.T, device=dev)
        return dm, setup.sys.ao, setup.sys.weights, setup.sys.ao_grad
    molecule = {"Decane65": "Decane", "npad184": "C17H31O6N5S",
                "npad200": "C33H56N7O17P3S",
                "npad384": "C33H56N7O17P3S"}.get(shape, shape)
    mol = from_xyz_file(os.path.join(ROOT, "molecules", molecule + ".xyz"))
    basis = build_basis(mol)
    grid = build_grid(mol, level=1, device=dev)
    pts = (slice(0, 65536) if shape.startswith("npad")
           else slice(None, None, 4))
    grad = None
    if fn.needs_grad:
        ao, grad = eval_ao(basis, grid.coords[pts], deriv=1, device=dev)
    else:
        ao = eval_ao(basis, grid.coords[pts], deriv=0, device=dev)
    w = torch.tensor(grid.weights[pts], device=dev)
    n = basis.nao
    pert = np.random.default_rng(19).standard_normal((n, n)) * 1e-2
    dm = torch.tensor(np.diag(sad_occupations(basis, mol.charges, mol.nelec))
                      + pert + pert.T, device=dev)
    sub = {"Decane65": 65, "npad200": 197}.get(shape)
    if sub is not None:
        dm, ao = dm[:sub, :sub], ao[:, :sub].contiguous()
        if grad is not None:
            grad = grad[:, :, :sub].contiguous()
    return dm, ao, w, grad


TC_SHAPES = [("H2O", 8), ("Decane65", 72), ("Decane", 72), ("DHA", 152),
             ("npad184", 184), ("npad200", 200), ("npad384", 384)]


def _check_tc(shape, npad, name):
    """K1 or K2 on the tensor cores at one shape: against its plain
    version, bitwise over two calls, launch count, and the f64 engine."""
    dev = _cuda()
    fn = FUNCTIONALS[name]
    dm, ao, w, grad = _tc_planes(shape, fn, dev)
    n = dm.shape[0]
    aot, wt, grads = fused_xc.pack_inputs(ao, w, grad,
                                          needs_grad=fn.needs_grad)
    assert aot.shape[0] == npad
    _check_kernel(fn, dm, aot, wt, grads, n)
    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
    e_64, v_64 = xc_step(fn, dm, ao, w, grad)
    assert abs(float(e_k) - float(e_64)) <= 5e-5 * max(abs(float(e_64)), 1.0)
    assert float(torch.abs(v_k - v_64).max()) < 5e-5


@pytest.mark.parametrize("shape,npad", TC_SHAPES)
@pytest.mark.parametrize("name", ["LDA", "HF"])
def test_cuda_k2_matches_plain_and_f64(shape, npad, name):
    _check_tc(shape, npad, name)


@pytest.mark.parametrize("shape,npad", TC_SHAPES)
@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
def test_cuda_k1_matches_plain_and_f64(shape, npad, name):
    _check_tc(shape, npad, name)


# K3 in both bodies and phi3 (K3's GGA body), on fused_xc_tc's bf16 mode
K3_CASES = [("LDA", {"phi_split": True}), ("B3LYP", {"phi_split": True}),
            ("B3LYP", {"ablate": "phi3"})]


def _peak_bytes(fn, dm, aot, wt, grads, n, **variant):
    """Device memory one call allocates beyond what was live before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


@pytest.mark.parametrize("shape,npad", TC_SHAPES)
@pytest.mark.parametrize("name,variant", K3_CASES,
                         ids=["K3-LDA", "K3-B3LYP", "phi3-B3LYP"])
def test_cuda_k3_and_phi3_match_plain_and_f64(shape, npad, name, variant):
    """K3 and phi3 at every K1/K2 shape (resident and streaming rho
    kernels, npad 8 to 384, with a last half k16 step at npad 8, 40, 72,
    152, 184 and 200): against the plain K3 (relative dE 1e-5, max
    dV 5e-5), bitwise over two calls, the launch count, the f64 engine
    (3e-4 and 3e-3, the JAX package's K3 contract), and no more device
    memory than K1's or K2's call on the same planes (no phi_D or B^T
    plane)."""
    dev = _cuda()
    fn = FUNCTIONALS[name]
    dm, ao, w, grad = _tc_planes(shape, fn, dev)
    n = dm.shape[0]
    aot, wt, grads = fused_xc.pack_inputs(ao, w, grad,
                                          needs_grad=fn.needs_grad)
    assert aot.shape[0] == npad
    _check_kernel(fn, dm, aot, wt, grads, n, **variant)
    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    e_64, v_64 = xc_step(fn, dm, ao, w, grad)
    assert abs(float(e_k) - float(e_64)) <= 3e-4 * max(abs(float(e_64)), 1.0)
    assert float(torch.abs(v_k - v_64).max()) < 3e-3
    assert _peak_bytes(fn, dm, aot, wt, grads, n, **variant) <= _peak_bytes(
        fn, dm, aot, wt, grads, n)


@pytest.mark.parametrize("shape,npad", TC_SHAPES)
@pytest.mark.parametrize("ablate", ["nophi", "nov"])
@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
def test_cuda_nophi_and_nov_run_on_k1_kernels(shape, npad, ablate, name):
    """nophi (K1's kernels with no phi_D product: the rho kernel reads no
    density) and nov (K1's rho kernel and E sum, no V kernel) at every
    K1/K2 shape (resident and streaming rho kernels, npad 8 to 384):
    against their plain versions (relative dE 1e-5, max dV 5e-5 of max(1,
    max |V|), as the other ablations), bitwise over two calls, the launch
    count, nov's V exactly zero and its E K1's bit for bit (the same rho
    kernel and the same E sum), and no more device memory than K1's call on
    the same planes."""
    dev = _cuda()
    fn = FUNCTIONALS[name]
    dm, ao, w, grad = _tc_planes(shape, fn, dev)
    n = dm.shape[0]
    aot, wt, grads = fused_xc.pack_inputs(ao, w, grad, needs_grad=True)
    assert aot.shape[0] == npad
    _check_kernel(fn, dm, aot, wt, grads, n, ablate=ablate)
    if ablate == "nov":
        e_k, _ = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, ablate="nov")
        e_1, _ = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
        assert torch.equal(e_k, e_1)
    assert _peak_bytes(fn, dm, aot, wt, grads, n, ablate=ablate) <= \
        _peak_bytes(fn, dm, aot, wt, grads, n)


@pytest.mark.parametrize("npad", [8, 40, 72, 152, 160, 168, 184, 200, 384])
@pytest.mark.parametrize("gpad", [1024, 65536, 138240, 634880, 1150976])
def test_cuda_k1_v_chunk_covers_the_grid_with_bounded_partials(npad, gpad):
    """K1's V chunk from the C side: whole 16-point slabs, every slab in
    one partial, the partials within 32 MB."""
    _cuda()
    chunk = fused_xc._lib().fused_xc_tc_v_chunk(npad, gpad)
    nchunk = -(-gpad // chunk)
    ldv = -(-npad // fused_xc.LDA_V_TILE) * fused_xc.LDA_V_TILE
    assert chunk > 0 and chunk % 16 == 0 and (nchunk - 1) * chunk < gpad
    assert nchunk * ldv * ldv <= fused_xc.LDA_V_PART_FLOATS


@pytest.mark.parametrize("density_fit", [False, True])
def test_scf_jit_graphs_match_the_eager_cycle(density_fit):
    """scf_jit's CUDA-graph replays against the same cycle run eagerly on
    the card: the same cycle count, energies within 1e-10 Eh (one
    arithmetic, replayed), and the host f64 loop within 1e-9 Eh."""
    from quantum_compute_dft_tpu_torch.scf.driver import (
        _jit_carry,
        _jit_cycle,
        _run_cycle,
        scf_host,
        scf_jit,
    )

    dev = _cuda()
    setup = kohn_sham.prepare(
        from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz")), "B3LYP",
        grid_level=1, density_fit=density_fit, device=dev)
    s, fn = setup.sys, setup.functional
    dm, eb, n_iter, done = scf_jit(s, fn)
    st = _jit_carry(s)
    for _ in range(n_iter + 3):   # past convergence: masked, no change
        _run_cycle(_jit_cycle(s, fn, st, 200))
    assert done and bool(st["done"]) and int(st["cycle"]) == n_iter
    assert abs(eb.e_tot - float(st["energies"][0])) < 1e-10
    assert float(torch.abs(dm - st["dm"]).max()) < 1e-10
    ref = scf_host(s, fn, xc_impl="f64")
    assert ref.converged and abs(eb.e_tot - ref.e_tot) < 1e-9


@pytest.mark.parametrize("entry", ["panel", "diagonal", "matrix"])
@pytest.mark.parametrize("molecule", ["H2", "H2O", "H2Se"])
def test_cuda_k4_matches_plain_version(molecule, entry):
    """K4 (csrc/eri_quartet.cu) against the eager tiles on the card at
    L = 0, 2 and 4 (H2, H2O, H2Se): one launch a call, within 1e-12 of max
    |W| (both f64, other summation order), a ragged pivot list of 11 and
    every 3rd pair as rows."""
    from quantum_compute_dft_tpu_torch.integrals import two_electron as te
    from quantum_compute_dft_tpu_torch.mol import from_xyz_text

    dev = _cuda()
    mol = (from_xyz_text("H 0 0 0\nH 0 0 0.74") if molecule == "H2" else
           from_xyz_file(os.path.join(ROOT, "molecules", molecule + ".xyz")))
    basis = build_basis(mol)
    iu, _, *hermite = te.pair_data(basis, dev)
    pairs = te.quartet_pairs(*hermite, 2 * int(basis.cart_powers.max()))
    rows = np.arange(0, len(iu), 3)
    cols = np.random.default_rng(15).choice(len(iu), min(11, len(iu)),
                                            replace=False)
    call = {"panel": (te.eri_columns, te.eri_columns_reference,
                      (pairs, rows, cols, 8)),
            "diagonal": (te.eri_diagonal, te.eri_diagonal_reference,
                         (pairs, rows, 8)),
            "matrix": (te.eri_matrix, te.eri_matrix_reference,
                       (pairs, rows, 8))}[entry]
    before = te.LAUNCHES["K4"]
    out = call[0](*call[2])
    torch.cuda.synchronize()  # a fault shows at the kernel that made it
    ref = call[1](*call[2])
    assert te.LAUNCHES["K4"] == before + 1
    assert out.shape == ref.shape and out.is_cuda
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    if entry == "matrix":
        assert torch.equal(out, out.T)


@pytest.mark.parametrize("deriv", [0, 1])
@pytest.mark.parametrize("molecule", ["H2O", "H2Se", "DHA"])
def test_cuda_k5_matches_plain_version(molecule, deriv):
    """K5 (csrc/ao_eval.cu) against the eager chunks on the card: H2O and
    H2Se (T = 9 terms, powers to 2) at grid 1, DHA's first 20,011 grid-3
    points (a ragged last tile); one launch a call, each plane within
    1e-13 of its largest magnitude.  Both are f64; the order of the term
    sums and the exp's last bits differ."""
    import warnings

    from quantum_compute_dft_tpu_torch.engine import ao_eval

    dev = _cuda()
    mol = from_xyz_file(os.path.join(ROOT, "molecules", molecule + ".xyz"))
    with warnings.catch_warnings():  # Se's tables are 'optimized'
        warnings.simplefilter("ignore", RuntimeWarning)
        basis = build_basis(mol)
    grid = build_grid(mol, level=3 if molecule == "DHA" else 1, device=dev)
    coords = grid.coords[:20011]
    before = ao_eval.LAUNCHES["K5"]
    got = eval_ao(basis, coords, deriv=deriv, device=dev)
    torch.cuda.synchronize()  # a fault shows at the kernel that made it
    ref = ao_eval.eval_ao_reference(basis, coords, deriv=deriv, device=dev)
    assert ao_eval.LAUNCHES["K5"] == before + 1
    pairs = zip(got, ref) if deriv else [(got, ref)]
    for out, plain in pairs:
        assert out.shape == plain.shape and out.is_cuda
        assert out.dtype == torch.float64 and out.is_contiguous()
        scale = float(plain.abs().max())
        assert float((out - plain).abs().max()) <= 1e-13 * scale


@pytest.mark.parametrize("name", ["LDA", "B3LYP"])
def test_cuda_prepare_counts_one_ao_launch(name):
    """prepare's AO planes (values for LDA, with gradients for B3LYP) are
    one K5 launch, which setup_split records."""
    dev = _cuda()
    setup = kohn_sham.prepare(
        from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz")), name,
        grid_level=1, device=dev)
    assert setup.setup_split["ao_kernel_launches"] == 1
    assert (setup.sys.ao_grad is not None) == FUNCTIONALS[name].needs_grad


@pytest.mark.parametrize("molecule, level", [
    ("H2O", 1), ("Benzene", 3), ("DHA", 3), ("Vitamin-B2", 3),
    ("C33H56N7O17P3S", 1)])
def test_cuda_k6_matches_plain_version(molecule, level):
    """K6 (csrc/becke.cu) against the eager chunks on the card, over the
    whole grid: H2O grid 1, Benzene, DHA and Vitamin-B2 grid 3 and the
    117-atom C33H56N7O17P3S grid 1 (whose pair tables, 219 KB, exceed a
    block's shared memory; 3, 12, 47 and 117 atoms leave a ragged last
    atom tile); one launch a call, each weight within 1e-12.  Both are
    f64; the order of the products and the multiplication by 1/R_ij
    differ."""
    from quantum_compute_dft_tpu_torch.grids import becke

    dev = _cuda()
    mol = from_xyz_file(os.path.join(ROOT, "molecules", molecule + ".xyz"))
    grid = build_grid(mol, level=level, device=dev)
    args = (grid.coords, mol.coords, grid.atom_idx, mol.bragg_radii())
    before = becke.LAUNCHES["K6"]
    got = becke.becke_partition(*args, device=dev)
    assert becke.LAUNCHES["K6"] == before + 1
    ref = becke.becke_weights_chunked(*args, device=dev)
    assert got.shape == ref.shape and got.dtype == np.float64
    assert float(np.abs(got - ref).max()) <= 1e-12


def test_cuda_prepare_counts_one_becke_launch(tmp_path, monkeypatch):
    """prepare on a cold cache builds the grid's partition in one K6
    launch and times it; on a warm one it loads the grid: 0 launches."""
    dev = _cuda()
    monkeypatch.setenv("DFT_SETUP_CACHE", "1")
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path))
    mol = from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz"))
    cold = kohn_sham.prepare(mol, "LDA", grid_level=1, device=dev)
    warm = kohn_sham.prepare(mol, "LDA", grid_level=1, device=dev)
    assert cold.setup_split["becke_kernel_launches"] == 1
    assert 0.0 < cold.setup_split["becke_s"] <= cold.setup_split["grid_s"]
    assert "grid" in warm.cache_hits
    assert warm.setup_split["becke_kernel_launches"] == 0
