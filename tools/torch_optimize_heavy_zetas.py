"""Run the port's variational zeta optimizer over the Z = 21-54 elements.

    python tools/torch_optimize_heavy_zetas.py OUT.json [SYMBOL ...]
        [--device cuda|cpu]

The port of tools/optimize_heavy_zetas.py.  Writes the JSON that
tools/torch_apply_optimized_zetas.py reads: one entry per element
{"zetas": {...}, "e_opt": .., "e_table": .., "frozen": shell}, and a
"header" entry with the device (on the card nvidia-smi's name and power
limit).  OUT is rewritten after each element and a rerun skips the
elements it holds, so the run resumes.

Frozen shells (kept at their molecular-convention table values, the
convention of the published STO-3G tables): the metal valence sp shells,
where a free-atom minimization drifts to diffuse exponents that are wrong
in molecules (Sc-Zn 4sp; Rb-Cd 5sp).  Main-group valence shells (Ga-Kr
4sp, In-Xe 5sp) optimize freely.  No symbols: all Z = 21-54.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

PERIOD4_METALS = ["Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn"]
PERIOD4_MAIN = ["Ga", "Ge", "As", "Se", "Br", "Kr"]
PERIOD5_METALS = ["Rb", "Sr", "Y", "Zr", "Nb", "Mo", "Tc", "Ru", "Rh",
                  "Pd", "Ag", "Cd"]
PERIOD5_MAIN = ["In", "Sn", "Sb", "Te", "I", "Xe"]
ALL = PERIOD4_METALS + PERIOD4_MAIN + PERIOD5_METALS + PERIOD5_MAIN


def frozen_for(symbol: str) -> tuple[str, ...]:
    if symbol in PERIOD4_METALS:
        return ("4sp",)
    if symbol in PERIOD5_METALS:
        return ("5sp",)
    return ()


def optimize_one(sym: str, device: str) -> dict:
    """One element's entry: the table energy and the optimized zetas."""
    from quantum_compute_dft_tpu_torch.basis.atomic_scf import (
        atomic_energy,
        optimize_zetas,
    )
    from quantum_compute_dft_tpu_torch.basis.data import ZETA, shells_for_z
    from quantum_compute_dft_tpu_torch.mol.elements import Z_OF

    t0 = time.time()
    frozen = frozen_for(sym)
    table = {sh: ZETA[sym][sh][0] for sh in shells_for_z(Z_OF[sym])}
    e_table = atomic_energy(sym, table, device=device)
    zetas, e_opt = optimize_zetas(sym, frozen_shells=frozen, verbose=True,
                                  device=device)
    return {"zetas": zetas, "e_opt": e_opt, "e_table": e_table,
            # torch_apply_optimized_zetas reads a single shell name here
            "frozen": frozen[0] if frozen else None,
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", help="results JSON; resumed when it exists")
    p.add_argument("symbols", nargs="*", help="elements (default: Z = 21-54)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch_kernel_timing as kt

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    results["header"] = dict(kt.card(args.device),
                             tool="tools/torch_optimize_heavy_zetas.py")

    def save():
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    save()
    for sym in args.symbols or ALL:
        if sym in results and "error" not in results[sym]:
            print(f"{sym}: in {args.out}, skipping", flush=True)
            continue
        try:
            row = optimize_one(sym, args.device)
            print(f"{sym}: E {row['e_table']:.6f} -> {row['e_opt']:.6f} "
                  f"(dE {row['e_opt'] - row['e_table']:+.6f}, "
                  f"{row['seconds']:.1f} s)", flush=True)
        except Exception as exc:  # resumable: record and move on
            row = {"error": repr(exc)}
            print(f"{sym}: FAILED {exc!r}", flush=True)
        results[sym] = row
        save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
