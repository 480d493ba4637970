"""Where the time of the PyTorch port's SCF goes, on one CUDA GPU.

    python tools/profile_torch_scf.py [FUNCTIONAL] [MOLECULE] [--grid-level N]

Prepares the molecule on the card, runs the 'fast' SCF once to warm up,
then reports (1) the median time of each piece of one cycle, timed with
CUDA events over 20 repetitions at the converged density, and (2) a
torch.profiler trace of one whole 'fast' SCF: device time by kernel name
and the device's busy share of the wall time.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _ms(fn, reps=20):
    import torch

    fn()
    out = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("functional", nargs="?", default="GGA")
    p.add_argument("molecule", nargs="?", default="Benzene")
    p.add_argument("--grid-level", type=int, default=3)
    args = p.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_scf: needs a CUDA GPU")
    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf import driver as d
    from quantum_compute_dft_tpu_torch.engine.xc_engine import (
        xc_energy,
        xc_step,
    )

    dev = torch.device("cuda")
    mol = from_xyz_file(os.path.join(ROOT, "molecules",
                                     args.molecule + ".xyz"))
    t0 = time.time()
    setup = kohn_sham.prepare(mol, args.functional,
                              grid_level=args.grid_level, device=dev)
    torch.cuda.synchronize()
    s, fn = setup.sys, setup.functional
    jk = ("in-core ERIs" if s.eri is not None else
          f"Cholesky DF rank {s.df_bq.shape[0]}, {setup.df_time:.3f} s")
    print(f"prepare: {time.time() - t0:.3f} s (nao {setup.nao}, ngrid "
          f"{setup.ngrid}, {jk})")
    res = d.scf_host(s, fn, xc_impl="fast")
    dm = res.dm
    diis = d.diis_init(dm.shape[0], device=dev)
    f = s.hcore.clone()
    pieces = {
        "fused XC kernel (f32)": lambda: d._fused_xc(s, fn, dm),
        "J (f64)": lambda: d._build_j(s, dm),
        "CDIIS update": lambda: d.diis_update(diis, f, dm, s.s, s.x),
        "eigh density": lambda: d._density(s.x, f, s.nocc, s.nopen),
        "density sanity": lambda: d._density_sanity(s, dm, dm),
        "whole fast cycle + stat fetch": lambda: d.scf_iteration_fast(
            s, fn, dm, diis)[2].tolist(),
        "f64 xc_step (verify cycles)": lambda: xc_step(
            fn, dm, s.ao, s.weights, s.ao_grad),
        "whole f64 cycle + stat fetch": lambda: d.scf_iteration(
            s, fn, dm, diis)[2].tolist(),
        "f64 xc_energy (final energy)": lambda: xc_energy(
            fn, dm, s.ao, s.weights, s.ao_grad),
    }
    if s.eri is not None or s.df_l is not None:
        pieces["K (f64)"] = lambda: d._build_k(s, dm)
    if s.df_bq32 is not None:
        pieces["K (f32, DF kernel phase)"] = lambda: d._build_k(
            s, dm, fast=True)
    for name, fn_ in pieces.items():
        print(f"  {name:32s} {_ms(fn_):9.4f} ms (median of 20)")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = d.scf_host(s, fn, xc_impl="fast")
        torch.cuda.synchronize()
        wall = time.time() - t0
    # device busy time: the kernels' own spans (the aten ops' device
    # totals would count each kernel twice)
    dev_us = sum(e.device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
    events = prof.key_averages()
    print(f"fast SCF: {res.n_iter} cycles ({res.fast_cycles} kernel, "
          f"{res.verify_cycles} f64), E={res.e_tot:.10f}, wall {wall:.4f} s"
          f" under the profiler, device busy {dev_us / 1e6:.4f} s "
          f"({100.0 * dev_us / 1e6 / wall:.1f}% of wall)")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
