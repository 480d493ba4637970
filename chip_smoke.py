"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its result and seconds on its own line; any failure
raises and the script exits non-zero without the final line):

  1. environment: nvidia-smi name/power limit, device, torch/scipy/nvcc
  2. build the fused XC kernels (K1 GGA body, K2 LDA body) from csrc/
  3. each kernel against its plain PyTorch version and the f64 engine on
     H2O (grid 1) and benzene (grid 3) for LDA/GGA/B3LYP, bitwise equal
     results from two calls (deterministic reductions), finiteness of
     the device functional over extreme (rho, sigma), kernel and plain
     times at the benzene shape (median of 25 calls, CUDA events)
  4. the main path: the port's CLI in process on GGA benzene, LDA H2O and
     B3LYP H2Se at grid level 3 with --xc-impl fast, checked against the
     reference energies, with the kernels' launch counts

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


def phase_kernels():
    """Kernel vs plain vs f64 engine; returns per-kernel records."""
    t0 = time.time()
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess
    from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

    dev = torch.device("cuda")
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
            e_k, v_k = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
            e_k2, v_k2 = fused_xc.fused_xc(fn, dm, aot, wt, grads, n)
            if not (torch.equal(e_k, e_k2) and torch.equal(v_k, v_k2)):
                raise AssertionError(f"{mol_name}/{fname}: two kernel calls "
                                     "differ (reductions must be "
                                     "deterministic)")
            e_p, v_p = fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n)
            e_64, v_64 = xc_step(fn, dm, s.ao, s.weights, s.ao_grad)
            torch.cuda.synchronize()
            e_k, e_p, e_64 = float(e_k), float(e_p), float(e_64)
            dv_p = float(torch.abs(v_k - v_p).max())
            dv_64 = float(torch.abs(v_k - v_64).max())
            de_p = abs(e_k - e_p) / abs(e_p)
            de_64 = abs(e_k - e_64) / abs(e_64)
            kid = "K1" if fn.needs_grad else "K2"
            print(f"  {kid} {mol_name}/{fname} nao={n} ngrid={setup.ngrid}: "
                  f"rel dE plain {de_p:.2e} f64 {de_64:.2e}; max dV plain "
                  f"{dv_p:.2e} f64 {dv_64:.2e}", flush=True)
            if not (np.isfinite([e_k, dv_p, dv_64]).all()
                    and de_p < TOL_PLAIN and dv_p < TOL_PLAIN
                    and de_64 < TOL_F64 and dv_64 < TOL_F64):
                raise AssertionError(
                    f"{kid} {mol_name}/{fname} outside tolerance")
            rec[kid]["max_abs_err"] = max(rec[kid]["max_abs_err"], dv_p)
            if mol_name == "Benzene" and fname in ("LDA", "GGA"):
                rec[kid]["ms"] = _cuda_ms(
                    lambda: fused_xc.fused_xc(fn, dm, aot, wt, grads, n))
                rec[kid]["plain_ms"] = _cuda_ms(
                    lambda: fused_xc.fused_xc_reference(fn, dm, aot, wt,
                                                        grads, n))
                print(f"  {kid} benzene {fname} time: kernel "
                      f"{rec[kid]['ms']:.4f} ms, plain "
                      f"{rec[kid]['plain_ms']:.4f} ms (median of 25)",
                      flush=True)

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


def phase_main():
    """The port's CLI entry in process; returns the launch counts."""
    t0 = time.time()
    import torch

    from quantum_compute_dft_tpu_torch import cli
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    runs = (("GGA", "Benzene", BENZENE_E, BENZENE_TOL),
            ("LDA", "H2O") + _golden("H2O", "LDA"),
            ("B3LYP", "H2Se") + _golden("H2Se", "B3LYP"))
    for k in fused_xc.LAUNCHES:
        fused_xc.LAUNCHES[k] = 0
    fast_cycles = {"K1": 0, "K2": 0}
    for fname, mol, e_ref, tol in runs:
        t1 = time.time()
        setup, res, scf_s = cli.run([
            fname, mol, "--molecules-dir", os.path.join(HERE, "molecules"),
            "--grid-level", "3", "--xc-impl", "fast", "--device", "cuda"])
        torch.cuda.synchronize()
        kid = "K1" if setup.functional.needs_grad else "K2"
        fast_cycles[kid] += res.fast_cycles
        print(f"  {fname} {mol}: converged={res.converged} cycles="
              f"{res.n_iter} (kernel {res.fast_cycles}, f64 verify "
              f"{res.verify_cycles}) E={res.e_tot:.10f} dE_ref="
              f"{res.e_tot - e_ref:+.2e} SCF {scf_s:.3f} s, total "
              f"{time.time() - t1:.2f} s", flush=True)
        if not res.converged or abs(res.e_tot - e_ref) >= tol:
            raise AssertionError(f"{fname} {mol}: E={res.e_tot} vs "
                                 f"{e_ref} (tol {tol})")
    launches = dict(fused_xc.LAUNCHES)
    for kid in ("K1", "K2"):
        if launches[kid] < max(1, fast_cycles[kid]):
            raise AssertionError(f"{kid}: {launches[kid]} launches for "
                                 f"{fast_cycles[kid]} kernel-phase cycles")
    _phase("4 main path", t0, f"launches {launches}, kernel-phase cycles "
           f"{fast_cycles}")
    return launches


def main() -> int:
    smi = phase_env()
    phase_build()
    rec = phase_kernels()
    launches = phase_main()
    import torch

    kernels = [{
        "name": f"{kid} fused_xc {'GGA' if kid == 'K1' else 'LDA'} body",
        "route": "cuda",
        "source": KERNEL_SRC,
        "replaces": REPLACES[kid],
        "launches": launches[kid],
        "max_abs_err": rec[kid]["max_abs_err"],
        "ms": rec[kid]["ms"],
        "plain_ms": rec[kid]["plain_ms"],
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
