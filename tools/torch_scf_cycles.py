"""Kernel-phase cycle counts of the port's fast SCF with K1 against K1base
(K1 on the four-kernel pipeline), from seeded perturbed starting densities:
whether K1's design changes how many f32 cycles the SCF takes.

    python tools/torch_scf_cycles.py [--seeds N] [--scale X]
        [--molecules Decane,DHA] [--grids 2,3]

For each molecule (B3LYP; density-fitted above nao 64) and grid level: one
prepare, then scf_host(xc_impl="fast") from the SAD density (seed 0) and
from N seeded perturbations of it (SAD + X (P + P^T), P standard normal
from numpy's default_rng(seed)), once with K1 and once with K1base, which
the script swaps into the driver's fused XC call (the SCF itself passes no
variant).  Prints one JSON line per run (molecule, grid level, seed,
kernel, kernel-phase and f64 verify cycles, which test ended the kernel
phase: "rule" for |dE| < 1e-8 and ||dD|| < 1e-6, "streak" for
FAST_DN_STREAK cycles of ||dD|| < 1e-6; energy, SCF seconds), then one
summary line per molecule and grid level, and the card's name and power
limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--scale", type=float, default=1e-3)
    ap.add_argument("--molecules", default="Decane,DHA")
    ap.add_argument("--grids", default="2,3")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_scf_cycles: no CUDA device")
    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf import driver

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    k1 = driver._fused_xc

    def k1base(s, functional, dm):
        aot, wt, grads = driver._packed_for(s, functional.needs_grad)
        return fused_xc.fused_xc(functional, dm, aot, wt, grads,
                                 s.hcore.shape[0], base=True)

    for name in args.molecules.split(","):
        mol = from_xyz_file(os.path.join(HERE, "molecules", name + ".xyz"))
        for level in map(int, args.grids.split(",")):
            setup = kohn_sham.prepare(mol, "B3LYP", grid_level=level,
                                      device="cuda")
            s = setup.sys
            dm_sad = driver.initial_guess(s)
            n = dm_sad.shape[0]
            counts = {"K1": [], "K1base": []}
            for seed in range(args.seeds + 1):
                dm0 = dm_sad
                if seed:
                    p = np.random.default_rng(seed).standard_normal((n, n))
                    dm0 = dm_sad + torch.tensor(args.scale * (p + p.T),
                                                device=dm_sad.device)
                for kernel, xc in (("K1", k1), ("K1base", k1base)):
                    log = []
                    launches = fused_xc.LAUNCHES[kernel]
                    driver._fused_xc = xc
                    try:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        res = driver.scf_host(
                            s, setup.functional, xc_impl="fast", dm0=dm0,
                            callback=lambda c, eb, de, dn: log.append((de, dn)))
                        torch.cuda.synchronize()
                        scf_s = time.perf_counter() - t0
                    finally:
                        driver._fused_xc = k1
                    if fused_xc.LAUNCHES[kernel] - launches != res.fast_cycles:
                        raise AssertionError(f"{kernel}: launches do not match "
                                             "the kernel-phase cycles")
                    de, dn = log[res.fast_cycles - 1]
                    end = ("rule" if abs(de) < driver.CONV_TOL_E
                           and dn < driver.CONV_TOL_D else "streak")
                    counts[kernel].append(res.fast_cycles)
                    print(json.dumps({
                        "molecule": name, "grid": level, "seed": seed,
                        "kernel": kernel, "converged": res.converged,
                        "kernel_cycles": res.fast_cycles,
                        "verify_cycles": res.verify_cycles, "end": end,
                        "e_tot": res.e_tot, "scf_s": scf_s}), flush=True)
            print(json.dumps({
                "summary": f"{name} grid {level}", "nao": n,
                "scale": args.scale, **{
                    k: {"kernel_cycles": v, "mean": statistics.mean(v)}
                    for k, v in counts.items()}}), flush=True)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
