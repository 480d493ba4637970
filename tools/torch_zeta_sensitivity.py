"""Heavy-element zeta sensitivity through the port: dE/dzeta per shell and
the per-element energy error bar, held against the JAX package's values.

    python tools/torch_zeta_sensitivity.py [OUT.md] [--device cuda|cpu]

The port of tools/zeta_sensitivity.py: the central finite difference
(REL_STEP 0.005 of zeta) of the spherically-averaged atomic-HF energy
(basis/atomic_scf.atomic_energy) at the shipped zetas, for every shell of
HEAVY, and the per-element error bar

    err(el) = sum over shells of |dE/dzeta_s| * (REL_UNC * zeta_s)

with REL_UNC = 2%.  Each derivative is held against REFERENCE
(docs/zeta_sensitivity.md.cache.json, the JAX package's derivatives) within
TOL.  The derivatives are cached as they complete in OUT.md.cache.json,
beside OUT.md (default docs/zeta_sensitivity_h100.md), so a cut run
resumes.  The table names the device (on the card nvidia-smi's name and
power limit) and each derivative's seconds.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

HEAVY = ["Cu", "As", "Se", "Br", "Mo", "I"]
REL_STEP = 0.005   # finite-difference step
REL_UNC = 0.02     # assumed zeta uncertainty (2x the validated ~1%)
# |dE/dzeta| against the reference: two energies that agree to ~1e-11 Eh
# over a step of 2 * 0.005 zeta (zeta >= ~1)
TOL = 1e-8
REFERENCE = os.path.join(ROOT, "docs", "zeta_sensitivity.md.cache.json")


def derivative(sym: str, shell: str, device: str = "cuda") -> float:
    """Central difference dE/dzeta of `shell` at the table zetas."""
    from quantum_compute_dft_tpu_torch.basis.atomic_scf import atomic_energy
    from quantum_compute_dft_tpu_torch.basis.data import ZETA

    zt = {sh: z for sh, (z, _prov) in ZETA[sym].items()}
    h = REL_STEP * zt[shell]
    ep = atomic_energy(sym, dict(zt, **{shell: zt[shell] + h}),
                       device=device)
    em = atomic_energy(sym, dict(zt, **{shell: zt[shell] - h}),
                       device=device)
    return (ep - em) / (2 * h)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", default=os.path.join(
        ROOT, "docs", "zeta_sensitivity_h100.md"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.basis.data import ZETA

    head = kt.card(args.device)
    with open(REFERENCE) as f:
        ref = json.load(f)
    cache_path = args.out + ".cache.json"
    cache = {}
    if os.path.exists(cache_path):
        with open(cache_path) as f:
            cache = json.load(f)
        cache.pop("header", None)
    where = (f"{head['gpu']}, {head['power_limit']} power limit"
             if head["gpu"] else "the CPU")
    lines = [
        "# Heavy-element zeta sensitivity through the PyTorch port",
        "",
        "Central-difference dE/dzeta (step 0.5% of zeta) of the",
        "spherically-averaged atomic-HF energy at the shipped zetas,",
        f"and the per-element error bar at a {REL_UNC:.0%} zeta uncertainty,",
        "from `tools/torch_zeta_sensitivity.py --device "
        f"{args.device}` on {where} (torch {head['torch']}).",
        f"Each derivative is held against `{os.path.relpath(REFERENCE, ROOT)}`",
        f"(the JAX package's) within {TOL:g}; s is the seconds of its two",
        "atomic energies (blank when it came from this run's cache).",
        "",
        "| Element | Shell | zeta | dE/dzeta (Eh) | JAX dE/dzeta | diff | "
        "|dE| at 2% (Eh) | s |",
        "|---|---|---|---|---|---|---|---|",
    ]
    totals, worst, missing = {}, 0.0, []
    for sym in HEAVY:
        tot = 0.0
        for sh, (z0, _prov) in ZETA[sym].items():
            key = f"{sym}/{sh}"
            secs = ""
            if key in cache:
                d = cache[key]["dE_dzeta"]
            else:
                t0 = time.time()
                d = derivative(sym, sh, args.device)
                secs = f"{time.time() - t0:.2f}"
                cache[key] = {"dE_dzeta": d, "seconds": time.time() - t0}
                with open(cache_path, "w") as f:
                    json.dump(dict(cache, header=head), f, indent=1)
            bar = abs(d) * REL_UNC * z0
            tot += bar
            r = ref.get(key)
            if r is None:
                missing.append(key)
                diff_s, r_s = "n/a", "n/a"
            else:
                worst = max(worst, abs(d - r))
                diff_s, r_s = f"{d - r:+.2e}", f"{r:+.10f}"
            print(f"{sym} {sh}: zeta={z0:.4f} dE/dz={d:+.10f} ref {r_s} "
                  f"bar={bar:.5f} {secs}", flush=True)
            lines.append(f"| {sym} | {sh} | {z0:.4f} | {d:+.10f} | {r_s} | "
                         f"{diff_s} | {bar:.5f} | {secs} |")
        totals[sym] = tot
        lines.append(f"| **{sym}** | total | | | | | **{tot:.5f}** | |")
    ok = worst < TOL and not missing
    lines += [
        "",
        f"Largest |dE/dzeta - JAX| over {len(cache)} derivatives: "
        f"{worst:.2e} ({'within' if ok else 'OUTSIDE'} {TOL:g}"
        + (f"; no reference for {missing}" if missing else "") + ").",
        "",
        "Per-molecule error bar = sum of the per-element totals over the",
        "molecule's heavy atoms:",
        "",
        "| Element | error bar (Eh) |",
        "|---|---|",
    ]
    lines += [f"| {sym} | {tot:.5f} |" for sym, tot in totals.items()]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps({"out": args.out, "derivatives": len(cache),
                      "max_abs_diff": worst, "within": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
