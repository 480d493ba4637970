"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises and the script exits non-zero without the final line):

  1. environment: nvidia-smi name/power limit, device, torch/scipy/nvcc
  2. build the fused XC kernels (K1 GGA body, K2 LDA body) from csrc/
  3. each kernel against its plain PyTorch version and the f64 engine on
     H2O (grid 1) and benzene (grid 3) for LDA/GGA/B3LYP, and above npad
     64 at the density-fitting shapes: Decane's first 65 AOs (npad 72,
     ragged), Decane and DHA (npad 72, 152; grid 3) and the first 65,536
     grid-1 points of C33H56N7O17P3S (npad 384), K1 (B3LYP) and K2 (LDA);
     bitwise equal results from two calls (deterministic reductions),
     finiteness of the device functional over extreme (rho, sigma), kernel
     and plain times at the benzene and DHA shapes (median of 25 calls,
     CUDA events)
  4. the main paths, each with the kernels' launch counts set to 0 just
     before it and read just after, through the port's CLI in process with
     --xc-impl fast at grid level 3:
     a. in-core: GGA benzene, LDA H2O and B3LYP H2Se against the reference
        energies;
     b. density fitting (auto above nao 64): B3LYP Decane and DHA against
        docs/RESULTS.md, and LDA Decane against the port's own
        --xc-impl f64 run of the same molecule

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Imports nothing of JAX; needs a CUDA GPU.
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
BENZENE_E = -229.10950264    # BENCH_r05.json, Benzene PBE grid 3
BENZENE_TOL = 1e-6
# docs/RESULTS.md:61, 68 (B3LYP grid 3, density-fitted).  The reference
# rows come from another Cholesky factorization: the DF parity bar of
# tests/test_density_fitting.py
DECANE_E = -389.66540042
DHA_E = -995.41205421
DF_TOL = 1e-6
FAST_VS_F64_TOL = 1e-7       # tests/test_torch_scf.py
# phase 3's density-fitting shapes: (molecule, grid level, first points)
DF_SHAPES = (("Decane", 3, None), ("DHA", 3, None),
             ("C33H56N7O17P3S", 1, 65536))
KERNEL_SRC = "quantum_compute_dft_tpu_torch/csrc/fused_xc.cu"
REPLACES = {
    "K1": "quantum_compute_dft_tpu/engine/pallas_xc.py:201",
    "K2": "quantum_compute_dft_tpu/engine/pallas_xc.py:269",
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


def _compare(label, kid, fn, dm, aot, wt, grads, n, ao64, w64, grad64, rec):
    """One kernel call against the plain version and the f64 engine, and
    two calls bitwise equal; records the worst plain deviation."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step

    e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
    e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
    if not (torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)):
        raise AssertionError(f"{kid} {label}: two kernel calls differ "
                             "(reductions must be deterministic)")
    e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n)
    e_64, v_64 = xc_step(fn, dm, ao64, w64, grad64)
    torch.cuda.synchronize()
    e_k, e_p, e_64 = float(e_k), float(e_p), float(e_64)
    dv_p = float(torch.abs(v_k - v_p).max())
    dv_64 = float(torch.abs(v_k - v_64).max())
    de_p = abs(e_k - e_p) / abs(e_p)
    de_64 = abs(e_k - e_64) / abs(e_64)
    print(f"  {kid} {label} nao={n} npad={aot.shape[0]} points="
          f"{ao64.shape[0]}: rel dE plain {de_p:.2e} f64 {de_64:.2e}; max dV "
          f"plain {dv_p:.2e} f64 {dv_64:.2e}", flush=True)
    if not (np.isfinite([e_k, dv_p, dv_64]).all()
            and de_p < TOL_PLAIN and dv_p < TOL_PLAIN
            and de_64 < TOL_F64 and dv_64 < TOL_F64):
        raise AssertionError(f"{kid} {label} outside tolerance")
    rec[kid]["max_abs_err"] = max(rec[kid]["max_abs_err"], dv_p)


def _time(kid, label, fn, dm, aot, wt, grads, n, rec, key):
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    ms = _cuda_ms(lambda: fused_xc.fused_xc(fn, dm, aot, wt, grads, n))
    plain = _cuda_ms(lambda: fused_xc.fused_xc_reference(fn, dm, aot, wt,
                                                         grads, n))
    rec[kid][key + "ms"], rec[kid][key + "plain_ms"] = ms, plain
    print(f"  {kid} {label} time: kernel {ms:.4f} ms, plain {plain:.4f} ms "
          "(median of 25)", flush=True)


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
    """Kernel vs plain vs f64 engine; returns per-kernel records."""
    t0 = time.time()
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    rec = {k: {"max_abs_err": 0.0} for k in ("K1", "K2")}
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
            _compare(f"{mol_name}/{fname}", kid, fn, dm, aot, wt, grads, n,
                     s.ao, s.weights, s.ao_grad, rec)
            if mol_name == "Benzene" and fname in ("LDA", "GGA"):
                _time(kid, f"benzene {fname}", fn, dm, aot, wt, grads, n,
                      rec, "")
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
            _compare(f"{label}/{fname}", kid, fn, dm, aot, wt, grads, n, ao,
                     w, g, rec)
            if label.startswith("DHA"):
                _time(kid, f"DHA {fname}", fn, dm, aot, wt, grads, n, rec,
                      "dha_")
            del aot, wt, grads
        del dm, ao, w, grad
        torch.cuda.empty_cache()
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
    return rec


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


def main() -> int:
    smi = phase_env()
    phase_build()
    import torch

    dev = torch.device("cuda")
    rec = phase_kernels(dev)
    incore, df = phase_main(dev)

    kernels = [{
        "name": f"{kid} fused_xc {'GGA' if kid == 'K1' else 'LDA'} body",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": REPLACES[kid],
        "launches": df[kid],
        "incore_launches": incore[kid],
        "max_abs_err": rec[kid]["max_abs_err"],
        "ms": rec[kid]["ms"],
        "plain_ms": rec[kid]["plain_ms"],
        "dha_ms": rec[kid]["dha_ms"],
        "dha_plain_ms": rec[kid]["dha_plain_ms"],
    } for kid in ("K1", "K2")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    sys.exit(main())
