"""Per-cycle ||dD|| traces of the `fast` SCF on the benchmark's placements:
the data the stall handover's thresholds (scf/driver.py, STALL_*) are
chosen from.

    python tools/torch_dnorm_traces.py --out FILE [--cells W [W ...]]
        [--northstar-grid N] [--northstar-variants stall off f64]

For each cell of BENCHMARK.json named (default: all of them) and each
placement of its configuration's pool (bench_torch/harness.py), one job per
functional of its traffic through the CLI entry, cli.run, with the
configuration's arguments and a setup cache of the placement's own.  With
--northstar-grid, then C33H56N7O17P3S (the pool's first placement) under
B3LYP at that grid level, once per variant: "stall" as the CLI runs it,
"off" with no stall handover (the kernel phase runs to --max-cycle), "f64"
on the f64 schedule; none of them retries on the annealing ladder.  Each
job appends one JSON line to FILE: the per-cycle dE and ||dD|| the CLI
prints, the kernel-phase and verify cycles, the handover, the energy, the
seconds and, on the card, the peak device memory.  Needs a CUDA card unless
--device cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORTHSTAR = os.path.join(ROOT, "molecules", "C33H56N7O17P3S.xyz")


def parse_table(text: str) -> list:
    """[(dE, ||dD||)] from the CLI's per-cycle table."""
    rows = []
    for line in text.splitlines():
        f = line.split()
        if len(f) == 5 and f[0].isdigit():
            try:
                rows.append((float(f[2]), float(f[3])))
            except ValueError:
                continue
    return rows


def job(argv: list, device: str) -> dict:
    """One cli.run job; -> its record."""
    import torch

    from quantum_compute_dft_tpu_torch import cli

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        setup, res, scf_s = cli.run(argv)
    rows = parse_table(out.getvalue())
    rec = dict(
        converged=bool(res.converged), e_tot=float(res.e_tot),
        n_iter=res.n_iter, fast_cycles=res.fast_cycles,
        verify_cycles=res.verify_cycles,
        handover=getattr(res, "handover", None),
        stall_wait_cycles=getattr(res, "stall_wait_cycles", None),
        shift_engaged_at=res.shift_engaged_at, nao=setup.nao,
        ngrid=setup.ngrid, prepare_s=setup.build_time, scf_s=scf_s,
        wall_s=time.perf_counter() - t0, cache_hits=setup.cache_hits,
        de=[r[0] for r in rows], dnorm=[r[1] for r in rows])
    if device == "cuda":
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--cells", nargs="*", default=None)
    p.add_argument("--northstar-grid", type=int, default=None)
    p.add_argument("--northstar-variants", nargs="+",
                   choices=("stall", "off", "f64"), default=["stall"])
    p.add_argument("--max-cycle", type=int, default=200)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from bench_torch import harness
    from quantum_compute_dft_tpu_torch.scf import driver

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("torch_dnorm_traces: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
        gpu = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    else:
        gpu = "cpu"
    extra = ["--device", "cpu"] if args.device == "cpu" else []

    def emit(rec):
        rec["gpu"] = gpu
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("de", "dnorm")}), flush=True)

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = (args.cells if args.cells is not None
             else [w["name"] for w in bench["workloads"]])
    with tempfile.TemporaryDirectory(prefix="dnorm_traces_") as scratch:
        for name in cells:
            c = harness.cell(name)
            conf = c["config"]
            syms, geoms = harness.geometry_pool(
                os.path.join(ROOT, conf["molecule"]), conf["geometries"], 0)
            for g, xyz in enumerate(geoms):
                path = os.path.join(scratch, f"{name}_{g}.xyz")
                harness.write_xyz(path, syms, xyz)
                os.environ["DFT_SETUP_CACHE_DIR"] = os.path.join(
                    scratch, f"cache_{conf['name']}_{g}")
                for fn in c["traffic"]["functionals"]:
                    rec = job([fn, path, *conf["argv"], *extra], args.device)
                    emit(dict(cell=name, geom=g, functional=fn, **rec))
        if args.northstar_grid is not None:
            syms, geoms = harness.geometry_pool(NORTHSTAR, 1, 0)
            path = os.path.join(scratch, "northstar.xyz")
            harness.write_xyz(path, syms, geoms[0])
            os.environ["DFT_SETUP_CACHE_DIR"] = os.path.join(
                scratch, "cache_northstar")
            keep = driver.STALL_WINDOW
            for variant in args.northstar_variants:
                if variant == "off":
                    driver.STALL_WINDOW = 10 ** 9
                try:
                    rec = job(["B3LYP", path, "--grid-level",
                               str(args.northstar_grid), "--xc-impl",
                               "f64" if variant == "f64" else "fast",
                               "--max-cycle", str(args.max_cycle),
                               "--no-auto-anneal", *extra], args.device)
                finally:
                    driver.STALL_WINDOW = keep
                emit(dict(cell="northstar", grid=args.northstar_grid,
                          variant=variant, **rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
