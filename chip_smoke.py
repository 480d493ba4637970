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
     c. FON-RKS and the annealing ladder: B3LYP CuO on the CLI's defaults
        (the fast integer-occupation attempt fails, the ladder runs on the
        f64 loop) within 1e-7 Eh of its golden row at the row's kT 0.2 (when
        the ladder stops at another kT, the golden tool's recheck, rungs
        down to 0.2 on damped mixing, is held to the row instead);
        GGA (K1) and LDA (K2) CaCO3 at --smear-kt 0.2, fast against f64
        within 1e-7 Eh, each kernel launched at least once per CaCO3
        kernel-phase cycle
     d. the RI auxiliary tiers: B3LYP Decane with --df-aux tight and
        --df-aux fast through the CLI, each within 1e-7 Eh of the JAX
        package's CPU energy for the same tier and grid
        (docs/ri_reference_cpu.json, tools/ri_reference.py); the card's
        RI tensors against the CPU's (H2O 'tight', H2Se 'fast') within
        1e-11 of their largest magnitude; DHA B3LYP on the 'fast' tier, one
        kohn_sham.prepare for both scf_host schedules, fast within 1e-7 Eh
        of f64, and on the 'tight' tier (fast schedule), each with its RI
        build seconds and peak device memory beside 4b's Cholesky seconds
        and its distance from the Cholesky row's energy (the tier's error,
        printed, not bounded); K1 launched at least once per kernel-phase
        cycle of these runs; and a checkpoint round trip:
        H2O LDA through the CLI with --checkpoint twice (f64 schedule), the
        second run resuming from the first's density in no more cycles,
        within 1e-8 Eh
     e. the north star, C33H56N7O17P3S B3LYP at grid level 1 (nao 377,
        540,054 points) on a pivoted-Cholesky factor at tol 1e-5 handed to
        kohn_sham.prepare(_df_override=...) by tools/torch_northstar.py's
        setup and scf, the f64 schedule, within 1e-6 Eh of the JAX
        package's v5e energy (its rank and grid size printed beside the JAX
        package's); then K1 and its plain version timed at its converged
        density on the whole grid (npad 384), after it is held against its
        plain version and the f64 engine there.  The fast schedule's kernel
        phase stalls there (tools/torch_northstar.py, PERF.md): it is not
        run here
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
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOOLS = os.path.join(HERE, "tools")

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
# phase 4d: the RI tiers against the JAX package's CPU energies, and the
# checkpoint round trip (tests/test_aux.py's resume bar)
RI_REF = os.path.join(HERE, "docs", "ri_reference_cpu.json")
RI_TOL = 1e-7
RESUME_TOL = 1e-8
# the card's j3c and v2c against the same built on the CPU, of their
# largest magnitude (tests/test_torch_ri.py's bar against the JAX package)
RI_CPU_TOL = 1e-11
# (molecule, tier) of that check: g aux functions on O, and the Hermite sum
# to 8 (d shells on Se with g aux functions)
RI_CPU_CHECK = (("H2O", "tight"), ("H2Se", "fast"))
# phase 4e: the north star within 1e-6 Eh of the JAX package's L1 run on
# one v5e (tools/torch_northstar.py holds its molecule, energy, grid size
# and factor rank)
NORTHSTAR_TOL = 1e-6
GOLDEN_TOL = 1e-7            # tests/golden_energies.json's tolerance
# phase 4c's electronic temperature (Eh): that of the golden table's six
# smeared rows (tools/gen_golden.py's ladder)
FON_KT = 0.2
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


def _time(kid, label, case, rec, key, variant=None):
    """Kernel and plain ms (median of 25, CUDA events) beside the bound
    (tools/torch_kernel_timing.py: on the nao AOs and the grid's points of
    this case), recorded under key + ms, plain_ms, bound_ms, bound_by."""
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    variant = variant or {}
    args = case[1:7]
    ms = kt.cuda_ms(lambda: fused_xc.fused_xc(*args, **variant))
    plain = kt.cuda_ms(lambda: fused_xc.fused_xc_reference(*args, **variant))
    bound, by, t_b, t_o, t_fp32 = kt.xc_bound(kid, case[1].needs_grad,
                                              case[6], case[7].shape[0])
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
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.engine import fused_xc

    dm, aot = case[2], case[3]
    dm_p = fused_xc._pad_dm(dm, aot.shape[0])
    with fused_xc._full_f32_matmul():
        ms = kt.cuda_ms(lambda: (dm_p @ aot, aot @ aot.T))
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


def _golden_row(molecule, functional):
    with open(os.path.join(HERE, "tests", "golden_energies.json")) as f:
        g = json.load(f)
    for row in g["rows"]:
        if row["molecule"] == molecule and row["functional"] == functional:
            return row
    raise KeyError((molecule, functional))


def _golden(molecule, functional):
    return _golden_row(molecule, functional)["e_tot"], GOLDEN_TOL


def _reset_launches():
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    for k in fused_xc.LAUNCHES:
        fused_xc.LAUNCHES[k] = 0


def _cli(fname, mol, dev, e_ref, *args):
    """One run of the port's CLI in process at grid level 3; prints its
    line (dE_ref against e_ref, n/a for None) -> (setup, SCFResult)."""
    import torch

    from quantum_compute_dft_tpu_torch import cli

    t1 = time.time()
    setup, res, scf_s = cli.run([
        fname, mol, "--molecules-dir", os.path.join(HERE, "molecules"),
        "--grid-level", "3", "--device", dev.type, *args])
    torch.cuda.synchronize()
    dref = "n/a" if e_ref is None else f"{res.e_tot - e_ref:+.2e}"
    jk = cli.jk_label(setup)
    print(f"  {fname} {mol} {' '.join(args) or '(CLI defaults)'}: converged="
          f"{res.converged} cycles={res.n_iter} (kernel "
          f"{res.fast_cycles}, f64 verify {res.verify_cycles}) kT="
          f"{res.smear_kt:g} E={res.e_tot:.10f} dE_ref={dref} setup "
          f"{setup.build_time:.2f} s ({jk}) SCF {scf_s:.3f} s, total "
          f"{time.time() - t1:.2f} s", flush=True)
    return setup, res


def _run_path(name, runs, dev):
    """CLI runs in process with the launch counts set to 0 just before and
    read just after; returns the counts and the Cholesky seconds per
    molecule.  runs: (functional, molecule, xc_impl, reference energy,
    tolerance); the reference "previous" is the energy of the run before,
    None checks convergence only."""
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    t0 = time.time()
    _reset_launches()
    fast_cycles = {"K1": 0, "K2": 0}
    cholesky_s = {}
    e_prev = None
    for fname, mol, xc_impl, e_ref, tol in runs:
        e_ref = e_prev if e_ref == "previous" else e_ref
        setup, res = _cli(fname, mol, dev, e_ref, "--xc-impl", xc_impl)
        if setup.df_aux == "parity":
            cholesky_s[mol] = setup.df_time
        if xc_impl == "fast":
            fast_cycles["K1" if setup.functional.needs_grad else "K2"] += \
                res.fast_cycles
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
    return launches, cholesky_s


def phase_main(dev):
    """The port's CLI entry in process on both paths; returns the launch
    counts of each and the density-fitted path's Cholesky seconds."""
    incore, _ = _run_path("4a main path, in-core", (
        ("GGA", "Benzene", "fast", BENZENE_E, BENZENE_TOL),
        ("LDA", "H2O", "fast") + _golden("H2O", "LDA"),
        ("B3LYP", "H2Se", "fast") + _golden("H2Se", "B3LYP")), dev)
    df, cholesky_s = _run_path("4b main path, density fitting", (
        ("B3LYP", "Decane", "fast", DECANE_E, DF_TOL),
        ("B3LYP", "DHA", "fast", DHA_E, DF_TOL),
        ("LDA", "Decane", "f64", None, None),
        ("LDA", "Decane", "fast", "previous", FAST_VS_F64_TOL)), dev)
    return incore, df, cholesky_s


def phase_fon(dev):
    """4c: FON-RKS and the annealing ladder through the CLI, with the launch
    counts set to 0 just before and read just after; returns them.  CuO
    B3LYP on the CLI's defaults: the fast integer-occupation attempt fails
    and the ladder's result must match the golden row at its kT; CaCO3 GGA
    (K1) and LDA (K2) at --smear-kt FON_KT, fast against f64."""
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    import torch_run_all_molecules as tool

    t0 = time.time()
    _reset_launches()
    row = _golden_row("CuO", "B3LYP")
    setup, res = _cli("B3LYP", "CuO", dev, row["e_tot"])
    cuo_k1 = fused_xc.LAUNCHES["K1"]
    if not (res.converged and res.smear_kt > 0.0 and cuo_k1 > 0):
        raise AssertionError(f"CuO B3LYP: the ladder did not converge after "
                             f"the integer attempt (K1 launches {cuo_k1})")
    e, kt = res.e_tot, res.smear_kt
    cuo = f"the CLI's ladder at kT {kt:g}"
    if kt != row["smear_kt"]:
        # which rung is the coldest to converge hangs on rounding (ADIIS
        # on CuO's kT 0.25 rung, see tool.RECHECK_MIXER; the JAX package
        # itself now stops at 0.35 on the CPU, tools/golden_drift.py
        # --ladder): hold the energy at the row's kT by the recheck
        rr = tool.recheck(setup.sys, setup.functional, row["smear_kt"])
        e, kt = rr.e_tot, rr.smear_kt
        cuo += (f", then the recheck ({tool.RECHECK_MIXER} rungs) at kT "
                f"{kt:g}: converged={rr.converged} cycles={rr.n_iter} "
                f"E={e:.10f} dE_ref={e - row['e_tot']:+.2e}")
        print(f"  B3LYP CuO: {cuo}", flush=True)
        if not rr.converged:
            raise AssertionError("CuO B3LYP: the recheck did not converge")
    if kt != row["smear_kt"] or abs(e - row["e_tot"]) >= GOLDEN_TOL:
        raise AssertionError(f"CuO B3LYP: E={e} at kT {kt} vs "
                             f"{row['e_tot']} at kT {row['smear_kt']}")
    fast_cycles = {"K1": 0, "K2": 0}
    for fname, kid in (("GGA", "K1"), ("LDA", "K2")):
        e = {}
        for xc_impl in ("f64", "fast"):
            _, res = _cli(fname, "CaCO3", dev, e.get("f64"), "--xc-impl",
                          xc_impl, "--smear-kt", str(FON_KT))
            if not (res.converged and res.smear_kt == FON_KT):
                raise AssertionError(f"CaCO3 {fname} {xc_impl} at kT "
                                     f"{FON_KT} did not converge")
            e[xc_impl] = res.e_tot
            if xc_impl == "fast":
                fast_cycles[kid] += res.fast_cycles
        if abs(e["fast"] - e["f64"]) >= FAST_VS_F64_TOL:
            raise AssertionError(f"CaCO3 {fname} kT {FON_KT}: fast {e['fast']}"
                                 f" vs f64 {e['f64']}")
    launches = dict(fused_xc.LAUNCHES)
    caco3 = {"K1": launches["K1"] - cuo_k1, "K2": launches["K2"]}
    for kid in ("K1", "K2"):
        if caco3[kid] < max(1, fast_cycles[kid]):
            raise AssertionError(f"4c: {kid} {caco3[kid]} launches for "
                                 f"{fast_cycles[kid]} kernel-phase cycles")
    _phase("4c FON and the ladder", t0, f"CuO B3LYP ({cuo}) within "
           f"{GOLDEN_TOL:g} of the golden row at kT {row['smear_kt']:g} (K1 "
           f"launches {cuo_k1}); CaCO3 at kT {FON_KT:g} fast = f64; "
           f"launches {launches}, CaCO3 kernel-phase cycles {fast_cycles}")
    return launches


def phase_ri(dev, cholesky_s):
    """4d: the RI tiers and the checkpoint round trip, with the launch
    counts set to 0 just before and read just after; returns them.
    cholesky_s: 4b's Cholesky seconds per molecule, printed beside the RI
    build's."""
    import contextlib
    import io

    import torch

    from quantum_compute_dft_tpu_torch import cli, kohn_sham
    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
        df_tensors,
    )
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    with open(RI_REF) as f:
        ref = {(r["molecule"], r["functional"], r["grid_level"], r["tier"]): r
               for r in json.load(f)["rows"]}
    t0 = time.time()
    _reset_launches()
    fast_cycles = 0
    for tier in ("tight", "fast"):
        row = ref[("Decane", "B3LYP", 3, tier)]
        setup, res = _cli("B3LYP", "Decane", dev, row["e_tot"], "--df-aux",
                          tier)
        fast_cycles += res.fast_cycles
        print(f"    RI build {setup.ri_time:.2f} s {json.dumps(setup.ri_split)}"
              f"; the JAX package's robust-fit J energy "
              f"{row['e_tot_robust_fit']:.10f} ({res.e_tot - row['e_tot_robust_fit']:+.2e})",
              flush=True)
        if not res.converged or abs(res.e_tot - row["e_tot"]) >= RI_TOL:
            raise AssertionError(f"Decane B3LYP {tier}: E={res.e_tot} vs the "
                                 f"JAX package's {row['e_tot']} (tol {RI_TOL})")

    for name, tier in RI_CPU_CHECK:
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        basis = build_basis(mol)
        ref = df_tensors(basis, mol, aux_level=tier)
        got = df_tensors(basis, mol, aux_level=tier, device=dev)
        rel = [float((g.cpu() - r).abs().max() / r.abs().max())
               for r, g in zip(ref, got)]
        print(f"  {name} '{tier}' RI tensors on the card against the CPU: "
              f"j3c {rel[0]:.2e}, v2c {rel[1]:.2e} of their largest "
              "magnitude", flush=True)
        if not max(rel) < RI_CPU_TOL:
            raise AssertionError(f"{name} {tier}: the card's RI tensors "
                                 f"depart from the CPU's by {max(rel)}")
        del ref, got

    mol = from_xyz_file(os.path.join(HERE, "molecules", "DHA.xyz"))
    e = {}
    for tier, schedules in (("fast", ("fast", "f64")), ("tight", ("fast",))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        setup = kohn_sham.prepare(mol, "B3LYP", grid_level=3,
                                  density_fit=True, df_aux=tier, device=dev)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        for xc_impl in schedules:
            t1 = time.time()
            res = scf_host(setup.sys, setup.functional, xc_impl=xc_impl)
            torch.cuda.synchronize()
            if not res.converged:
                raise AssertionError(f"DHA B3LYP {tier} tier, {xc_impl}: did "
                                     "not converge")
            e[tier, xc_impl] = res.e_tot
            if xc_impl == "fast":
                fast_cycles += res.fast_cycles
            print(f"  B3LYP DHA RI {tier} tier --xc-impl {xc_impl}: cycles="
                  f"{res.n_iter} (kernel {res.fast_cycles}, f64 verify "
                  f"{res.verify_cycles}) E={res.e_tot:.10f} dE_cholesky_row="
                  f"{res.e_tot - DHA_E:+.2e} SCF {time.time() - t1:.3f} s",
                  flush=True)
        print(f"  DHA {tier} setup {setup.build_time:.2f} s: RI build (naux "
              f"{setup.ri_split['naux']}) {setup.ri_time:.2f} s "
              f"{json.dumps(setup.ri_split)}, peak device memory {peak:.2f} "
              f"GB, against 4b's Cholesky {cholesky_s['DHA']:.2f} s",
              flush=True)
        del setup
    de = e["fast", "fast"] - e["fast", "f64"]
    print(f"  DHA 'fast' tier: fast - f64 {de:+.2e}", flush=True)
    if abs(de) >= FAST_VS_F64_TOL:
        raise AssertionError(f"DHA B3LYP fast tier: fast {e['fast', 'fast']} "
                             f"vs f64 {e['fast', 'f64']}")
    launches = dict(fused_xc.LAUNCHES)
    if launches["K1"] < max(1, fast_cycles):
        raise AssertionError(f"4d: K1 {launches['K1']} launches for "
                             f"{fast_cycles} kernel-phase cycles")

    ck = os.path.join(HERE, "build", "chip_smoke_checkpoint.npz")
    os.makedirs(os.path.dirname(ck), exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    runs = []
    for _ in range(2):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _, res, _ = cli.run([
                "LDA", "H2O", "--molecules-dir", os.path.join(HERE, "molecules"),
                "--grid-level", "3", "--device", dev.type, "--xc-impl", "f64",
                "--checkpoint", ck])
        runs.append((res, "Resuming from checkpoint" in out.getvalue()))
        print(f"  LDA H2O --checkpoint: resumed={runs[-1][1]} converged="
              f"{res.converged} cycles={res.n_iter} E={res.e_tot:.10f}",
              flush=True)
    (r1, resumed1), (r2, resumed2) = runs
    if (resumed1 or not resumed2 or not (r1.converged and r2.converged)
            or r2.n_iter > r1.n_iter or abs(r2.e_tot - r1.e_tot) >= RESUME_TOL):
        raise AssertionError("4d: the checkpoint round trip did not resume")
    _phase("4d RI tiers and checkpoints", t0, f"Decane tight/fast within "
           f"{RI_TOL:g} of the JAX package; the card's RI tensors = the "
           f"CPU's; DHA fast tier fast = f64; "
           f"launches {launches}, kernel-phase cycles {fast_cycles}; the "
           f"checkpoint resumed ({r1.n_iter} then {r2.n_iter} cycles)")
    return launches


def phase_northstar(dev, rec):
    """4e: the north star on the f64 schedule through prepare's external
    factor hook (tools/torch_northstar.py's setup and scf, the factor built
    here, not cached), then K1 timed on its whole grid (recorded under
    northstar_ in K1's record)."""
    import torch
    import torch_northstar as ns

    from quantum_compute_dft_tpu_torch.scf.driver import _packed_for

    t0 = time.time()
    setup, factor = ns.setup(device=dev, cache=False)
    res, t_scf = ns.scf(setup, "f64")
    de = res.e_tot - ns.JAX_E
    rank = factor["cd_rank"]
    print(f"  B3LYP {ns.MOLECULE} grid {ns.GRID_LEVEL}: nao={setup.nao} "
          f"ngrid={setup.ngrid} (JAX {ns.JAX_NGRID}) Cholesky tol "
          f"{ns.CD_TOL:g} rank {rank} (JAX {ns.JAX_CD_RANK}) "
          f"{factor['cholesky_s']:.2f} s, prepare {setup.build_time:.2f} s "
          f"{json.dumps(setup.setup_split)}; f64: converged={res.converged} "
          f"cycles={res.n_iter} E={res.e_tot:.10f} dE_jax={de:+.2e} SCF "
          f"{t_scf:.3f} s", flush=True)
    if (setup.ngrid != ns.JAX_NGRID or not res.converged
            or abs(de) >= NORTHSTAR_TOL):
        raise AssertionError(f"north star: E={res.e_tot} vs {ns.JAX_E} "
                             f"(tol {NORTHSTAR_TOL}), ngrid {setup.ngrid}")
    fn = setup.functional
    aot, wt, grads = _packed_for(setup.sys, fn.needs_grad)
    s = setup.sys
    case = (f"{ns.MOLECULE} grid {ns.GRID_LEVEL}, whole grid", fn, res.dm,
            aot, wt, grads, setup.nao, s.ao, s.weights, s.ao_grad)
    _compare(case[0], "K1", case, rec)
    _time("K1", case[0], case, rec, "northstar_")
    del setup, s, case, aot, wt, grads
    torch.cuda.empty_cache()
    _phase("4e north star", t0, f"f64 schedule within {NORTHSTAR_TOL:g} Eh "
           f"of the JAX package ({de:+.2e}); rank {rank}, ngrid "
           f"{ns.JAX_NGRID}")


def phase_sweep():
    """The variant sweep's entry point at DHA grid 3, in process, with the
    launch counts set to 0 just before and read just after; returns them."""
    t0 = time.time()
    import numpy as np

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    import torch_xc_sweep

    _reset_launches()
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
    incore, df, cholesky_s = phase_main(dev)
    fon = phase_fon(dev)
    ri = phase_ri(dev, cholesky_s)
    phase_northstar(dev, rec)
    sweep = phase_sweep()

    kernels = []
    for kid in REPLACES:
        entry = {"name": KERNEL_NAMES[kid], "route": "cuda",
                 "source": KERNEL_SRC, "replaces": REPLACES[kid]}
        if kid in ("K1", "K2"):  # the SCF's kernels: the main paths' counts
            entry.update(launches=df[kid], incore_launches=incore[kid],
                         fon_launches=fon[kid], ri_launches=ri[kid],
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
    sys.path[:0] = [HERE, TOOLS]
    sys.exit(main())
