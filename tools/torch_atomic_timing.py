"""Where the port's atomic HF spends its time on the card: the integrals
(one_electron + eri_full at several quartet block sizes) and the SCF loop
on the host against on the device, each energy against the JAX package's.

    python tools/torch_atomic_timing.py [O Cu Se I ...] [--blocks 16 32 64]
        [--reps 3] [--device cuda|cpu] [--out OUT.json]

For each element at its table zetas: seconds of atom_integrals, and of
eri_full alone per block size (the largest difference from
atom_integrals' ERIs beside it; on the card every block size runs the
same two K4 launches, since `block` tiles only the CPU path's eager
quartets), then seconds of atomic_scf (the SCF
loop) on host copies of the tensors, as atomic_energy runs it, and on the
device, the median of --reps runs each, and both energies minus
docs/atomic_reference_cpu.json (tools/atomic_reference.py).  One JSON line per element, with the card's
name and power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

REFERENCE = os.path.join(ROOT, "docs", "atomic_reference_cpu.json")


def _timed(fn, dev, reps):
    import torch

    times, out = [], None
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def time_element(sym: str, blocks, reps: int, dev, ref: dict) -> dict:
    import torch

    from quantum_compute_dft_tpu_torch.basis import atomic_scf
    from quantum_compute_dft_tpu_torch.integrals import eri_full

    row = {"element": sym}
    s_int, (basis, h, s, eri) = _timed(
        lambda: atomic_scf.atom_integrals(sym, device=dev), dev, reps)
    row.update(nao=basis.nao, ncart=basis.ncart, integrals_s=s_int)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    row["eri_block_s"] = {}
    for blk in blocks:
        t, e2 = _timed(lambda: eri_full(basis, block=blk, device=dev), dev,
                       reps)
        row["eri_block_s"][blk] = {"s": t, "max_diff": float(
            (e2 - eri).abs().max())}
    if dev.type == "cuda":
        row["eri_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    e_ref = ref.get("energies", {}).get(sym, {}).get("e")
    for loop, args in (("host", (h.cpu(), s.cpu(), eri.cpu())),
                       ("device", (h, s, eri))):
        t, (e, _) = _timed(
            lambda: atomic_scf.atomic_scf(basis, *args, sym), dev, reps)
        row[f"loop_{loop}_s"] = t
        row[f"e_{loop}"] = e
        row[f"de_{loop}"] = None if e_ref is None else e - e_ref
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("elements", nargs="*", default=["O", "Cu", "Se", "I"])
    p.add_argument("--blocks", nargs="*", type=int, default=[16, 32, 64])
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    import torch_kernel_timing as kt

    head = kt.card(args.device)
    ref = {}
    if os.path.exists(REFERENCE):
        with open(REFERENCE) as f:
            ref = json.load(f)
    rows = []
    for sym in args.elements:
        row = time_element(sym, args.blocks, args.reps,
                           torch.device(args.device), ref)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"header": head, "rows": rows}, f, indent=1)
    print(json.dumps(head), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
