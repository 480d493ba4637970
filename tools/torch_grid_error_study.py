"""Quadrature (grid) error of the grid levels through the PyTorch port.

    python tools/torch_grid_error_study.py [OUT.md] [--device cuda|cpu]

The port of tools/grid_error_study.py: for each (molecule, functional),
the converged SCF energy (kohn_sham.prepare(grid=build_grid(mol, level,
prune)) then scf_host, f64 schedule) at levels 1-4, pruned and unpruned,
minus the energy on the level-7 unpruned grid, which is converged far
below the production grid's error.  Writes OUT.md (default
docs/grid_error_study_h100.md) with the device (on the card nvidia-smi's
name and power limit) and the seconds of each grid's prepare and SCF
(with the setup cache on, as by default, the one-electron integrals and
in-core ERIs of a molecule load from it after its first grid).  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

CASES = ("H2O/LDA", "H2O/GGA", "Benzene/GGA")
LEVELS = (1, 2, 3, 4)
REF_LEVEL = 7


def energy(name: str, functional: str, level: int, prune: bool,
           device="cuda") -> dict:
    """The converged f64 SCF on one grid -> {ngrid, e_tot, converged, s}."""
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.grids import build_grid
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    t0 = time.time()
    mol = from_xyz_file(os.path.join(ROOT, "molecules", name + ".xyz"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        g = build_grid(mol, level=level, prune=prune, device=device)
        s = kohn_sham.prepare(mol, functional, grid=g, device=device)
    r = scf_host(s.sys, s.functional)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return {"level": level, "prune": prune, "ngrid": g.ngrid,
            "e_tot": r.e_tot, "converged": bool(r.converged),
            "n_iter": r.n_iter, "seconds": time.time() - t0}


def study(case: str, device="cuda") -> dict:
    name, functional = case.split("/")
    ref = energy(name, functional, REF_LEVEL, False, device)
    rows = [energy(name, functional, lv, pr, device)
            for lv in LEVELS for pr in (True, False)]
    for r in rows:
        r["de"] = r["e_tot"] - ref["e_tot"]
    return {"case": case, "ref": ref, "rows": rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", default=os.path.join(
        ROOT, "docs", "grid_error_study_h100.md"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch_kernel_timing as kt

    head = kt.card(args.device)
    where = (f"{head['gpu']}, {head['power_limit']} power limit"
             if head["gpu"] else "the CPU")
    lines = [
        "# Grid quadrature error study through the PyTorch port",
        "",
        f"`tools/torch_grid_error_study.py --device {args.device}` on "
        f"{where} (torch {head['torch']}): the converged f64 SCF energy at",
        "grid levels 1-4, pruned and unpruned, minus the energy on the "
        f"level-{REF_LEVEL} unpruned grid (GGA = PBE); s is each "
        "grid's prepare and SCF, the setup cache "
        f"{'off' if os.environ.get('DFT_SETUP_CACHE') == '0' else 'on'}.",
    ]
    ok = True
    for case in CASES:
        out = study(case, args.device)
        ref = out["ref"]
        print(json.dumps(out), flush=True)
        lines += [
            "",
            f"### {case}  (ref: level {REF_LEVEL} unpruned, "
            f"{ref['ngrid']} pts, E = {ref['e_tot']:.10f}, "
            f"{ref['seconds']:.2f} s)",
            "",
            "| level | pruned | ngrid | E - E_ref (Eh) | converged | cycles "
            "| s |",
            "|---|---|---|---|---|---|---|",
        ]
        for r in out["rows"]:
            lines.append(f"| {r['level']} | {r['prune']} | {r['ngrid']} | "
                         f"{r['de']:+.2e} | {r['converged']} | {r['n_iter']}"
                         f" | {r['seconds']:.2f} |")
        ok = ok and ref["converged"] and all(r["converged"]
                                             for r in out["rows"])
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(json.dumps({"out": args.out, "converged": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
