"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises and the script exits non-zero without the final line):

  1. environment: nvidia-smi name/power limit, device, torch/scipy/nvcc
  2. build the fused XC kernels (K1 GGA body, K2 LDA body, K3 and the K1
     variants) from csrc/
  3. each kernel against its plain PyTorch version and the f64 engine on
     H2O (grid 1) and benzene (grid 3) for LDA/GGA/B3LYP, and above npad
     64 at the density-fitting shapes: Decane's first 65 AOs (npad 72,
     ragged), Decane and DHA (npad 72, 152; grid 3) and the first 65,536
     grid-1 points of C33H56N7O17P3S (npad 384), K1 (B3LYP) and K2 (LDA);
     bitwise equal results from two calls (deterministic reductions),
     finiteness of the device functional over extreme (rho, sigma), kernel
     and plain times of K1 and K2 at benzene, Decane, DHA and npad 384
     (median of 25 calls, CUDA events) beside each one's bound; the rho, V
     and reduce kernels of K1 and of K2 timed apart at DHA from one
     torch.profiler trace each; the two products alone as full-f32
     torch.matmul at DHA, for context
     c. K3 (phi_D on bf16 tensor cores), GGA and LDA bodies, at every
        shape of 3a/3b: against the plain K3 (relative dE 1e-5, max dV
        5e-5) and the f64 engine (3e-4 and 3e-3, the JAX package's K3
        contract), bitwise equal over two calls; times at benzene and DHA
     d. K1base (K1 on the four-kernel pipeline, the ablations' base), each
        K1 ablation (nophi, phi3, noprod, nofunc, nov) and the split2 row
        sums at benzene (PBE) and DHA (B3LYP), split2 also in the LDA body,
        against their own plain versions (relative dE 1e-5; max dV 1e-5 for
        K1base and split2, of max(1, max |V|) 5e-5 for the ablations, whose
        V reaches 1e10 (nofunc), and 2e-3 for noprod, see TOL_NOPROD_V);
        nov's V exactly zero; times
  4. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after, through the port's CLI in process with
     --xc-impl fast at grid level 3:
     a. in-core: GGA benzene, LDA H2O and B3LYP H2Se against the reference
        energies;
     b. density fitting (auto above nao 64): B3LYP Decane and DHA against
        docs/RESULTS.md, and LDA Decane against the port's own
        --xc-impl f64 run of the same molecule
  5. the variant sweep (tools/torch_xc_sweep.py, in process) at DHA grid 3
     with the launch counts set to 0 just before it: one JSON line per
     variant, one launch of each variant's kernel per kernel call it made,
     each E within 1e-5 of its plain version

The last three lines are the kernels' JSON record (every kernel with its
launches on its path, its largest deviation from its plain version, its
time, the plain version's, its bound and what sets it, and library_ms:
null, since no one PyTorch call computes a fused XC body), the card's name
and power limit, and {"ok": true, "device": {...}}.  Imports nothing of
JAX; needs a CUDA GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# relative |dE| and max |dV|: kernel vs its plain f32 version (both f32,
# other summation order), and kernel vs the f64 engine (the Pallas
# kernel's contract, tests/test_pallas.py)
TOL_PLAIN = 1e-5
TOL_F64 = 5e-5
# K3 (3-pass bf16 phi_D): max dV against its plain version, and (relative
# dE, max dV) against the f64 engine (tests/test_pallas.py's K3 contract)
TOL_K3_PLAIN_V = 5e-5
TOL_K3_F64 = 3e-4, 3e-3
# the ablations' max dV against their plain versions, of max(1, max |V|).
# noprod's rho = sum phi_D cancels to near zero at some points, where the
# B3LYP potentials amplify the f32 rounding of that sum: 6.3e-4 of max |V|
# at DHA grid 3 (E agrees to 7e-8); scaling D by 1 + 1e-7 xi moves noprod's
# V by 3.5e-4 of max |V| there, K1's by 1.5e-7
TOL_ABLATE_V = 5e-5
TOL_NOPROD_V = 2e-3
BENZENE_E = -229.10950264    # BENCH_r05.json, Benzene PBE grid 3
BENZENE_TOL = 1e-6
# docs/RESULTS.md:61, 68 (B3LYP grid 3, density-fitted).  The reference
# rows come from another Cholesky factorization: the DF parity bar of
# tests/test_density_fitting.py
DECANE_E = -389.66540042
DHA_E = -995.41205421
DF_TOL = 1e-6
FAST_VS_F64_TOL = 1e-7       # tests/test_torch_scf.py
# the card's peaks for the bounds (H100 SXM data sheet, 700 W): HBM bytes/s
# and the TF32 tensor-core rate, at which the product FLOPs are counted;
# the FP32 pipe's rate, printed beside it
HBM_BYTES_S = 3.35e12
TF32_FLOP_S = 495e12
FP32_FLOP_S = 67e12
# phase 3's density-fitting shapes: (molecule, grid level, first points)
DF_SHAPES = (("Decane", 3, None), ("DHA", 3, None),
             ("C33H56N7O17P3S", 1, 65536))
KERNEL_SRC = "quantum_compute_dft_tpu_torch/csrc/fused_xc.cu"
_PX = "quantum_compute_dft_tpu/engine/pallas_xc.py:"
REPLACES = {
    "K1": _PX + "201", "K2": _PX + "269", "K1base": _PX + "201",
    "K3": _PX + "157",
    "nophi": _PX + "219", "phi3": _PX + "221", "noprod": _PX + "227",
    "nofunc": _PX + "243", "nov": _PX + "262", "split2": _PX + "187",
}
KERNEL_NAMES = {
    "K1": "K1 fused_xc GGA body", "K2": "K2 fused_xc LDA body",
    "K1base": "K1base fused_xc GGA body on the four-kernel pipeline",
    "K3": "K3 fused_xc phi_D on bf16 tensor cores (both bodies)",
    "nophi": "K1 ablation nophi", "phi3": "K1 ablation phi3",
    "noprod": "K1 ablation noprod", "nofunc": "K1 ablation nofunc",
    "nov": "K1 ablation nov", "split2": "fused_xc split2 row sums",
}


def _phase(name, t0, msg):
    print(f"[phase {name}] {msg} ({time.time() - t0:.2f} s)", flush=True)


def phase_env():
    t0 = time.time()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is false); this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    import scipy

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    nvcc = subprocess.run([fused_xc._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(smi.splitlines()[0])
    print(f"device: {torch.cuda.get_device_name(0)}  count: "
          f"{torch.cuda.device_count()}  torch {torch.__version__} (cuda "
          f"{torch.version.cuda})  scipy {scipy.__version__}  nvcc: {nvcc}")
    _phase("1 environment", t0, "ok")
    return smi.splitlines()[0]


def phase_build():
    t0 = time.time()
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    path = fused_xc.build()
    fused_xc._lib()
    _phase("2 build", t0, f"built {os.path.relpath(path, HERE)}")


def _cuda_ms(fn, reps=25, warm=3):
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(label, kid, case, rec, variant=None, tol_plain=(TOL_PLAIN,
             TOL_PLAIN), tol_f64=(TOL_F64, TOL_F64), v_scaled=False):
    """One kernel call of `variant` against its plain version (and, with
    tol_f64, the f64 engine), and two calls bitwise equal; records the
    worst plain deviation under `kid`.  v_scaled: the plain max dV bound
    is taken of max(1, max |V|).  -> the kernel's V."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step

    variant = variant or {}
    fn, dm, aot, wt, grads, n, ao64, w64, grad64 = case[1:]
    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **variant)
    if not (torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)):
        raise AssertionError(f"{kid} {label}: two kernel calls differ "
                             "(reductions must be deterministic)")
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n,
                                           **variant)
    torch.cuda.synchronize()
    e_k, e_p = float(e_k), float(e_p)
    dv_p = float(torch.abs(v_k - v_p).max())
    de_p = abs(e_k - e_p) / abs(e_p)
    tol_v = tol_plain[1]
    if v_scaled:
        tol_v *= max(1.0, float(v_p.abs().max()))
    msg = (f"  {kid} {label} nao={n} npad={aot.shape[0]} points="
           f"{ao64.shape[0]}: rel dE plain {de_p:.2e}")
    ok = (np.isfinite([e_k, dv_p]).all() and bool(torch.isfinite(v_k).all())
          and de_p < tol_plain[0] and dv_p < tol_v)
    if tol_f64 is not None:
        e_64, v_64 = xc_step(fn, dm, ao64, w64, grad64)
        e_64 = float(e_64)
        dv_64 = float(torch.abs(v_k - v_64).max())
        de_64 = abs(e_k - e_64) / abs(e_64)
        msg += f" f64 {de_64:.2e}; max dV plain {dv_p:.2e} f64 {dv_64:.2e}"
        ok = ok and np.isfinite(dv_64) and de_64 < tol_f64[0] and \
            dv_64 < tol_f64[1]
    else:
        msg += f"; max dV plain {dv_p:.2e} (max |V| {float(v_p.abs().max()):.3e})"
    print(msg, flush=True)
    if not ok:
        raise AssertionError(f"{kid} {label} outside tolerance")
    rec[kid]["max_abs_err"] = max(rec[kid]["max_abs_err"], dv_p)
    return v_k


def _bound(kid, case):
    """(ms, "bytes" | "operations"): the least time the card could take for
    one call on this case's data, counted on the nao AOs and the grid's
    points (the wrapper's padding to npad rows and gpad points is not
    work the function needs).  Bytes: each input read once (the f64 D, the
    f32 AO plane and for the GGA body its three gradient planes, the f32
    weights) and each output written once (the f64 V and E), at
    HBM_BYTES_S.  Operations: the products the variant computes, at the
    TF32 rate: phi_D = D AO, 2 nao^2 points FLOPs; V, symmetric, a syr2k
    (AO B^T + B AO^T) of 2 nao^2 points FLOPs for the GGA body and a syrk
    (AO diag(s) AO^T) of nao (nao + 1) points for the LDA body; nophi drops
    phi_D, nov drops V.  -> (ms, what sets it, the same FLOPs' ms on the
    FP32 pipe)."""
    fn, n, npts = case[1], case[6], case[7].shape[0]
    planes = 4 if fn.needs_grad else 1
    nbytes = 8 * (2 * n * n + 1) + 4 * (planes * n + 1) * npts
    flops = 0.0 if kid == "nophi" else 2.0 * n * n * npts
    if kid != "nov":
        flops += (2.0 * n * n if fn.needs_grad else n * (n + 1.0)) * npts
    t_b = nbytes / HBM_BYTES_S
    t_o = flops / TF32_FLOP_S
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            1e3 * t_b, 1e3 * t_o, 1e3 * flops / FP32_FLOP_S)


def _time(kid, label, case, rec, key, variant=None):
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    variant = variant or {}
    args = case[1:7]
    ms = _cuda_ms(lambda: fused_xc.fused_xc(*args, **variant))
    plain = _cuda_ms(lambda: fused_xc.fused_xc_reference(*args, **variant))
    bound, by, t_b, t_o, t_fp32 = _bound(kid, case)
    rec[kid].update({key + "ms": ms, key + "plain_ms": plain,
                     key + "bound_ms": bound, key + "bound_by": by})
    print(f"  {kid} {label} time: kernel {ms:.4f} ms, plain {plain:.4f} ms "
          f"(median of 25), bound {bound:.4f} ms ({by}; bytes {t_b:.4f}, "
          f"TF32 ops {t_o:.4f}, FP32 ops {t_fp32:.4f})", flush=True)


# phase 3b's timed shapes of K1 and K2 -> their record key prefix
DF_TIMED = {"Decane grid 3": "decane_", "DHA grid 3": "dha_",
            "C33H56N7O17P3S grid 1 first 65536 points": "npad384_"}


def _profile(kid, case, rec, calls=10):
    """K1's or K2's kernels timed apart from one torch.profiler trace of
    `calls` calls: device ms per call of each kernel, printed and
    recorded."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    args = case[1:7]
    for _ in range(3):
        fused_xc.fused_xc(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fused_xc.fused_xc(*args)
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        m = re.search(r"(xc_rho\w*|xc_\w+_v_kernel|xc_reduce_kernel)", ev.key)
        dev_us = getattr(ev, "device_time_total", 0) or getattr(
            ev, "cuda_time_total", 0)
        if m and dev_us:
            split[m.group(1)] = dev_us / 1e3 / calls
    if not split:
        raise AssertionError(f"{kid} profile: the trace shows no device time")
    rec[kid]["dha_split_ms"] = split
    print(f"  {kid} {case[0]} kernel split (torch.profiler, device ms per call, "
          f"{calls} calls): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in split.items()),
          flush=True)


def _products_matmul(case, rec):
    """For context: K1's two products alone as full-f32 torch.matmul
    (phi_D = D AO, and V's AO B^T at its shapes) on this case's planes."""
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    dm, aot = case[2], case[3]
    dm_p = fused_xc._pad_dm(dm, aot.shape[0])
    with fused_xc._full_f32_matmul():
        ms = _cuda_ms(lambda: (dm_p @ aot, aot @ aot.T))
    rec["K1"]["dha_products_matmul_ms"] = ms
    print(f"  K1 {case[0]}: the two products alone as full-f32 torch.matmul "
          f"{ms:.4f} ms (median of 25)", flush=True)


def _df_shapes(dev):
    """The density-fitting-size planes: (label, dm, ao, w, grad) f64 on the
    card with a seeded perturbed SAD density."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.basis.basis_set import sad_occupations
    from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao
    from quantum_compute_dft_tpu_torch.grids import build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file

    rng = np.random.default_rng(23)
    for name, level, npts in DF_SHAPES:
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        basis = build_basis(mol)
        grid = build_grid(mol, level=level, device=dev)
        coords, w = grid.coords[:npts], grid.weights[:npts]
        ao, grad = eval_ao(basis, coords, deriv=1, device=dev)
        n = basis.nao
        pert = rng.standard_normal((n, n)) * 1e-2
        dm = torch.tensor(np.diag(sad_occupations(basis, mol.charges,
                                                  mol.nelec)) + pert + pert.T,
                          device=dev)
        w = torch.tensor(w, device=dev)
        if name == "Decane":
            yield (f"Decane first 65 AOs grid {level}", dm[:65, :65],
                   ao[:, :65].contiguous(), w, grad[:, :, :65].contiguous())
        yield (f"{name} grid {level}" + (f" first {npts} points" if npts
                                         else ""), dm, ao, w, grad)


def phase_kernels(dev):
    """Kernel vs plain vs f64 engine; returns per-kernel records and the
    checked cases (label, functional, dm, packed planes, n, f64 planes),
    which phases 3c and 3d reuse."""
    t0 = time.time()
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    rec = {k: {"max_abs_err": 0.0} for k in REPLACES}
    cases = []
    rng = np.random.default_rng(7)
    for mol_name, level in (("H2O", 1), ("Benzene", 3)):
        mol = from_xyz_file(os.path.join(HERE, "molecules", mol_name + ".xyz"))
        for fname in ("LDA", "GGA", "B3LYP"):
            setup = kohn_sham.prepare(mol, fname, grid_level=level, device=dev)
            s, fn = setup.sys, setup.functional
            n = setup.nao
            pert = rng.standard_normal((n, n)) * 1e-2
            dm = initial_guess(s) + torch.as_tensor(pert + pert.T, device=dev)
            aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                                  needs_grad=fn.needs_grad)
            kid = "K1" if fn.needs_grad else "K2"
            case = (f"{mol_name}/{fname}", fn, dm, aot, wt, grads, n, s.ao,
                    s.weights, s.ao_grad)
            _compare(case[0], kid, case, rec)
            if mol_name == "Benzene" and fname in ("LDA", "GGA"):
                _time(kid, f"benzene {fname}", case, rec, "")
            cases.append(case)
    _phase("3a kernels, in-core shapes", t0, "K1/K2 match the plain "
           "version and the f64 engine")

    t1 = time.time()
    for label, dm, ao, w, grad in _df_shapes(dev):
        n = dm.shape[0]
        for kid, fname in (("K1", "B3LYP"), ("K2", "LDA")):
            fn = FUNCTIONALS[fname]
            g = grad if fn.needs_grad else None
            aot, wt, grads = fused_xc.pack_inputs(ao, w, g,
                                                  needs_grad=fn.needs_grad)
            case = (f"{label}/{fname}", fn, dm, aot, wt, grads, n, ao, w, g)
            _compare(case[0], kid, case, rec)
            if label in DF_TIMED:
                _time(kid, f"{label} {fname}", case, rec, DF_TIMED[label])
            if label.startswith("DHA"):
                _profile(kid, case, rec)
                if kid == "K1":
                    _products_matmul(case, rec)
            cases.append(case)
    _phase("3b kernels, density-fitting shapes", t1, "K1/K2 match the plain "
           "version and the f64 engine at npad 72, 152 and 384")

    # the device functional over the extreme (rho, sigma) mesh of
    # tests/test_pallas.py must stay finite
    r = np.concatenate([[0.0], 10.0 ** np.linspace(-12, 4, 40)])
    sg = np.concatenate([[0.0], 10.0 ** np.linspace(-20, 8, 40)])
    R, S = np.meshgrid(r, sg)
    rho = torch.tensor(R.ravel(), dtype=torch.float32, device=dev)
    sig = torch.tensor(S.ravel(), dtype=torch.float32, device=dev)
    for fname in ("LDA", "GGA", "B3LYP"):
        outs = fused_xc.functional_eval(FUNCTIONALS[fname], rho, sig)
        for a in outs:
            if a is not None and not bool(torch.isfinite(a).all()):
                raise AssertionError(f"non-finite {fname} functional on the "
                                     "extreme (rho, sigma) mesh")
    _phase("3 kernels", t0, "K1/K2 match the plain version and the f64 "
           "engine; functional finite over the extreme mesh")
    return rec, cases


# the cases timed in 3c/3d -> their record key prefix ("" benzene GGA body)
TIMED = {"Benzene/GGA": "", "Benzene/LDA": "lda_", "DHA grid 3/B3LYP": "dha_",
         "DHA grid 3/LDA": "dha_lda_"}


def phase_k3(cases, rec):
    """K3 at every phase-3 shape, GGA and LDA bodies."""
    t0 = time.time()
    k3 = {"phi_split": True}
    for case in cases:
        _compare(case[0], "K3", case, rec, k3, (TOL_PLAIN, TOL_K3_PLAIN_V),
                 TOL_K3_F64)
        if case[0] in TIMED:
            _time("K3", case[0], case, rec, TIMED[case[0]], k3)
    _phase("3c K3", t0, "K3 matches the plain K3 and the f64 engine at "
           "every phase-3 shape, GGA and LDA bodies")


def phase_variants(cases, rec):
    """K1base and the ablations (GGA body) and split2 (both bodies) at
    benzene and DHA against their plain versions; nov's V exactly zero;
    times in the GGA body."""
    from quantum_compute_dft_tpu_torch.engine.fused_xc import (
        ABLATIONS,
        VARIANTS,
    )

    t0 = time.time()
    for case in cases:
        label, fn = case[0], case[1]
        if label not in TIMED:
            continue
        for kid in (("K1base", "split2", *ABLATIONS) if fn.needs_grad
                    else ("split2",)):
            variant = VARIANTS[kid]
            tol_v = (TOL_NOPROD_V if kid == "noprod" else TOL_ABLATE_V
                     if kid in ABLATIONS else TOL_PLAIN)
            v = _compare(label, kid, case, rec, variant, (TOL_PLAIN, tol_v),
                         None, v_scaled=kid in ABLATIONS)
            if kid == "nov" and bool(v.any()):
                raise AssertionError(f"nov {label}: V is not zero")
            if fn.needs_grad:
                _time(kid, label, case, rec, TIMED[label], variant)
    _phase("3d K1 variants", t0, "K1base, the ablations and split2 match "
           "their plain versions at benzene and DHA; nov's V is zero")


def _golden(molecule, functional):
    with open(os.path.join(HERE, "tests", "golden_energies.json")) as f:
        g = json.load(f)
    for row in g["rows"]:
        if row["molecule"] == molecule and row["functional"] == functional:
            return row["e_tot"], g["tolerance"]
    raise KeyError((molecule, functional))


def _run_path(name, runs, dev):
    """CLI runs in process with the launch counts set to 0 just before and
    read just after; returns the counts.  runs: (functional, molecule,
    xc_impl, reference energy, tolerance); the reference "previous" is the
    energy of the run before, None checks convergence only."""
    import torch

    from quantum_compute_dft_tpu_torch import cli
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    t0 = time.time()
    for k in fused_xc.LAUNCHES:
        fused_xc.LAUNCHES[k] = 0
    fast_cycles = {"K1": 0, "K2": 0}
    e_prev = None
    for fname, mol, xc_impl, e_ref, tol in runs:
        t1 = time.time()
        setup, res, scf_s = cli.run([
            fname, mol, "--molecules-dir", os.path.join(HERE, "molecules"),
            "--grid-level", "3", "--xc-impl", xc_impl, "--device", dev.type])
        torch.cuda.synchronize()
        if xc_impl == "fast":
            fast_cycles["K1" if setup.functional.needs_grad else "K2"] += \
                res.fast_cycles
        e_ref = e_prev if e_ref == "previous" else e_ref
        dref = "n/a" if e_ref is None else f"{res.e_tot - e_ref:+.2e}"
        jk = "in-core" if setup.sys.eri is not None else (
            f"DF rank {setup.sys.df_bq.shape[0]}, Cholesky "
            f"{setup.df_time:.2f} s")
        print(f"  {fname} {mol} --xc-impl {xc_impl}: converged="
              f"{res.converged} cycles={res.n_iter} (kernel "
              f"{res.fast_cycles}, f64 verify {res.verify_cycles}) "
              f"E={res.e_tot:.10f} dE_ref={dref} setup "
              f"{setup.build_time:.2f} s ({jk}) SCF {scf_s:.3f} s, total "
              f"{time.time() - t1:.2f} s", flush=True)
        if not res.converged or (e_ref is not None
                                 and abs(res.e_tot - e_ref) >= tol):
            raise AssertionError(f"{fname} {mol}: E={res.e_tot} vs "
                                 f"{e_ref} (tol {tol})")
        e_prev = res.e_tot
    launches = dict(fused_xc.LAUNCHES)
    for kid in ("K1", "K2"):
        if launches[kid] < max(1, fast_cycles[kid]):
            raise AssertionError(f"{name}: {kid} {launches[kid]} launches "
                                 f"for {fast_cycles[kid]} kernel-phase "
                                 "cycles")
    _phase(name, t0, f"launches {launches}, kernel-phase cycles "
           f"{fast_cycles}")
    return launches


def phase_main(dev):
    """The port's CLI entry in process on both paths; returns the launch
    counts of each."""
    incore = _run_path("4a main path, in-core", (
        ("GGA", "Benzene", "fast", BENZENE_E, BENZENE_TOL),
        ("LDA", "H2O", "fast") + _golden("H2O", "LDA"),
        ("B3LYP", "H2Se", "fast") + _golden("H2Se", "B3LYP")), dev)
    df = _run_path("4b main path, density fitting", (
        ("B3LYP", "Decane", "fast", DECANE_E, DF_TOL),
        ("B3LYP", "DHA", "fast", DHA_E, DF_TOL),
        ("LDA", "Decane", "f64", None, None),
        ("LDA", "Decane", "fast", "previous", FAST_VS_F64_TOL)), dev)
    return incore, df


def phase_sweep():
    """The variant sweep's entry point at DHA grid 3, in process, with the
    launch counts set to 0 just before and read just after; returns them."""
    t0 = time.time()
    import numpy as np

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import torch_xc_sweep

    for k in fused_xc.LAUNCHES:
        fused_xc.LAUNCHES[k] = 0
    rows = torch_xc_sweep.sweep(["DHA", "3"])
    launches = dict(fused_xc.LAUNCHES)
    expect = dict.fromkeys(launches, 0)
    for row in rows:
        (name,) = fused_xc.launch_names(
            FUNCTIONALS["B3LYP"], **fused_xc.VARIANTS[row["variant"]])
        expect[name] += row["calls"]
        de = abs(row["e_xc"] - row["e_xc_plain"]) / abs(row["e_xc_plain"])
        if not (np.isfinite(row["e_xc"]) and de < TOL_PLAIN):
            raise AssertionError(f"sweep {row['variant']}: E {row['e_xc']} "
                                 f"vs plain {row['e_xc_plain']}")
    if [r["variant"] for r in rows] != list(fused_xc.VARIANTS):
        raise AssertionError("the sweep did not run every variant")
    if launches != expect:
        raise AssertionError(f"sweep launches {launches}, expected one per "
                             f"kernel call: {expect}")
    _phase("5 variant sweep (DHA grid 3)", t0, f"launches {launches}")
    return launches


def main() -> int:
    smi = phase_env()
    phase_build()
    import torch

    dev = torch.device("cuda")
    rec, cases = phase_kernels(dev)
    phase_k3(cases, rec)
    phase_variants(cases, rec)
    del cases
    torch.cuda.empty_cache()
    incore, df = phase_main(dev)
    sweep = phase_sweep()

    kernels = []
    for kid in REPLACES:
        entry = {"name": KERNEL_NAMES[kid], "route": "cuda",
                 "source": KERNEL_SRC, "replaces": REPLACES[kid]}
        if kid in ("K1", "K2"):  # the SCF's kernels: the main paths' counts
            entry.update(launches=df[kid], incore_launches=incore[kid],
                         sweep_launches=sweep[kid])
        else:
            entry["launches"] = sweep[kid]
        if entry["launches"] < 1:
            raise AssertionError(f"{kid} was not launched on its path")
        entry.update(rec[kid])
        entry["library_ms"] = None  # no one PyTorch call is a fused XC body
        missing = {"ms", "plain_ms", "bound_ms", "bound_by"} - set(entry)
        if missing:
            raise AssertionError(f"{kid}: no {sorted(missing)} in this run")
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
