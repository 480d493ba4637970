"""Where the time of the PyTorch port's SCF goes, on one CUDA GPU.

    python tools/profile_torch_scf.py [FUNCTIONAL] [MOLECULE] [--grid-level N]
        [--span-cost N]

Prepares the molecule on the card, runs the 'fast' SCF once to warm up,
then reports (1) the median time of each piece of one cycle, timed with
CUDA events over 20 repetitions at the converged density, and (2) a
torch.profiler trace of one whole 'fast' SCF with the program's spans on
(utils/profiling.recording): per span its host ms, the device ms and
launches of the kernels it launched, and the device idle gaps by span
(bench_torch/scf_trace.py reads the same), then device time by kernel name
and the device's busy share of the wall time, and (3) the same per-span
table for one whole cold job (``cli.run`` on an empty setup cache): the
job, prepare's stages, the cache's loads and stores, the Cholesky's card
and host pieces (when the molecule takes it), the SCF and the CLI's XC
statistic.  --span-cost N times N SCFs with the spans off and N with them
on, in turns, and prints the medians of the SCF's seconds (no profiler).
Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import statistics
import sys
import tempfile
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


def _table(table):
    """Prints a span table (bench_torch/scf_trace.span_table)."""
    print(f"  {'span':24s} {'host ms':>10s} {'device ms':>10s} "
          f"{'launches':>9s}")
    for name, row in table.items():
        print(f"  {name:24s} {row['host_ms']:10.3f} {row['device_ms']:10.3f}"
              f" {row['launches']:9d}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("functional", nargs="?", default="GGA")
    p.add_argument("molecule", nargs="?", default="Benzene")
    p.add_argument("--grid-level", type=int, default=3)
    p.add_argument("--span-cost", type=int, default=0, metavar="N")
    args = p.parse_args(argv)

    import torch
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
    from quantum_compute_dft_tpu_torch.utils.profiling import (
        busy_seconds,
        recording,
    )
    from quantum_compute_dft_tpu_torch import cli
    from bench_torch.scf_trace import parse, span_table, summarize

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
        with recording():
            res = d.scf_host(s, fn, xc_impl="fast")
        torch.cuda.synchronize()
        wall = time.time() - t0
    busy = busy_seconds(prof)
    print(f"fast SCF: {res.n_iter} cycles ({res.fast_cycles} kernel, "
          f"{res.verify_cycles} f64), E={res.e_tot:.10f}, wall {wall:.4f} s"
          f" under the profiler, device busy {busy:.4f} s "
          f"({100.0 * busy / wall:.1f}% of wall)")
    sm = summarize(prof.profiler.kineto_results.events(), res.fast_cycles,
                   True)
    print(f"  cycle ms (traced): kernel phase "
          f"{sm['traced_kernel_cycle_ms']:.4f}, verify "
          f"{sm['traced_verify_cycle_ms']:.4f}; per cycle "
          f"{sm['launches_per_cycle']:.1f} launches, "
          f"{sm['syncs_per_cycle']:.1f} waits; cycles and final energy "
          f"cover {100.0 * sm['covered']:.1f}% of the SCF span")
    _table(sm["spans"])
    print(f"  device idle {sm['idle_pct']:.1f}% of the SCF span; its 100 "
          "longest gaps by span (ms): " + ", ".join(
              f"{n} {ms:.3f}" for n, ms in sm["idle_ms_by_span"].items()))
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))

    argv = [args.functional, args.molecule, "--grid-level",
            str(args.grid_level), "--molecules-dir",
            os.path.join(ROOT, "molecules")]
    with tempfile.TemporaryDirectory() as cache:
        os.environ["DFT_SETUP_CACHE_DIR"] = cache
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with recording(), contextlib.redirect_stdout(io.StringIO()):
                job, res, _ = cli.run(argv)
            torch.cuda.synchronize()
    table, loose, _ = span_table(*parse(prof.profiler.kineto_results.events()),
                                 True)
    print(f"one cold job ({' '.join(argv[:4])}): E={res.e_tot:.10f}, "
          f"prepare {job.build_time:.4f} s; device ms launched outside "
          f"every span {loose:.3f}")
    _table(table)
    if args.span_cost:
        walls = {False: [], True: []}
        energies = set()
        for _ in range(args.span_cost):
            for on in (False, True):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with recording() if on else contextlib.nullcontext():
                    r = d.scf_host(s, fn, xc_impl="fast")
                torch.cuda.synchronize()
                walls[on].append(time.perf_counter() - t0)
                energies.add((on, r.e_tot))
        off, on = (statistics.median(walls[k]) for k in (False, True))
        print(f"span cost: scf_s median off {off:.6f} s, on {on:.6f} s "
              f"({100.0 * (on / off - 1.0):+.2f}%), {args.span_cost} each "
              f"in turns; off {[round(w, 6) for w in walls[False]]}, on "
              f"{[round(w, 6) for w in walls[True]]}; energies (spans on, "
              f"E): {sorted(energies | {(True, res.e_tot)})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
