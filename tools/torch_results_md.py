"""Render a sweep of tools/torch_run_all_molecules.py as a markdown table.

    python tools/torch_results_md.py [IN.json] [OUT.md]

Defaults: docs/results_58_h100.json -> docs/RESULTS_h100.md.  The card
(name and power limit) is read from the sweep's header.  Each row shows
the port's energy beside the JAX package's row of REFERENCE
(docs/results_58_r5.json; dE, the class of tools/compare_sweeps.py's first
test: parity at |dE| <= 2e-6) and the molecule's basis error bar: the sum over its atoms of the
per-element totals of the port's zeta sensitivity
(docs/zeta_sensitivity_h100.md.cache.json: |dE/dzeta| * 2% of zeta over
the element's shells), blank for elements with canonical tables.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SENSITIVITY = os.path.join(ROOT, "docs", "zeta_sensitivity_h100.md.cache.json")
REFERENCE = os.path.join(ROOT, "docs", "results_58_r5.json")
REL_UNC = 0.02
PARITY = 2e-6


def element_bars() -> dict[str, float]:
    """Per-element error bar (Eh) at a 2% zeta uncertainty."""
    from quantum_compute_dft_tpu_torch.basis.data import ZETA

    with open(SENSITIVITY) as f:
        cache = json.load(f)
    bars: dict[str, float] = {}
    for key, val in cache.items():
        if key == "header":
            continue
        sym, sh = key.split("/")
        bars[sym] = bars.get(sym, 0.0) + abs(val["dE_dzeta"]) * REL_UNC \
            * ZETA[sym][sh][0]
    return bars


def molecule_bar(name: str, bars: dict[str, float]) -> float:
    path = os.path.join(ROOT, "molecules", f"{name}.xyz")
    with open(path) as f:
        return sum(bars.get(p[0], 0.0) for line in f
                   if len(p := line.split()) == 4)


def render(results: dict, reference: dict, bars: dict) -> str:
    head = results.get("header", {})
    rows = [v for k, v in results.items()
            if k != "header" and "error" not in v]
    errs = {k: v for k, v in results.items()
            if k != "header" and "error" in v}
    rows.sort(key=lambda r: (r["natom"], r["molecule"], r["functional"]))
    n_conv = sum(1 for r in rows if r["converged"])
    n_par = n_ref = 0
    setup = sum(r["setup_s"] for r in rows)
    scf = sum(r["scf_s"] for r in rows)
    warm = [r["molecule"] for r in rows if r.get("cache_hits")]
    cold = ("cold: no row loaded anything from the setup cache" if not warm
            else f"{len(warm)} rows loaded setup artifacts from the setup "
            f"cache ({', '.join(warm)})")
    lines = [
        "# The reference's molecule set through the PyTorch port",
        "",
        f"`tools/torch_run_all_molecules.py` (xc_impl `{head.get('xc_impl')}`"
        f", grid level {rows[0]['grid_level'] if rows else '?'}, in-core "
        "ERIs up to nao 64 and Cholesky density fitting above, the FON-RKS "
        "annealing ladder when the integer-occupation SCF does not "
        f"converge) on {head.get('gpu') or head.get('device')}"
        + (f" at a {head['power_limit']} power limit" if head.get(
            "power_limit") else "")
        + f", torch {head.get('torch')} (CUDA {head.get('cuda')}), "
        f"sources {str(head.get('sources_sha256'))[:12]}; rendered by "
        "`tools/torch_results_md.py`. setup and SCF are host-clock seconds "
        f"ending in a device sync, {cold}.",
        "",
        "dE is the port's energy minus the JAX package's row in "
        "`docs/results_58_r5.json` (its energies only; its times are "
        "another device's). The basis bar sums the port's per-element "
        "zeta-sensitivity totals (`docs/zeta_sensitivity_h100.md`) over the "
        "molecule's atoms; blank = every element canonical.",
        "",
        "| Molecule | Func | atoms | nao | ngrid | DF | E_tot (Eh) | dE (Eh) |"
        " ± basis bar (Eh) | cycles (kernel) | kT | SCF (s) | setup (s) | "
        "basis |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        key = f"{r['molecule']}/{r['functional']}"
        ref = reference.get(key, {})
        if "e_tot" in ref:
            de = r["e_tot"] - ref["e_tot"]
            n_ref += 1
            n_par += abs(de) <= PARITY
            de_s = f"{de:+.2e}"
        else:
            de_s = "new row"
        bar = molecule_bar(r["molecule"], bars)
        prov = "+".join(p[0].upper() for p in r["basis_provenance"])
        lines.append(
            f"| {r['molecule']} | {r['functional']} | {r['natom']} | "
            f"{r['nao']} | {r['ngrid']} | {'Y' if r['density_fit'] else ''} |"
            f" {r['e_tot']:.8f}{'' if r['converged'] else ' (UNCONV)'} | "
            f"{de_s} | {f'{bar:.1e}' if bar > 0 else ''} | {r['n_iter']} "
            f"({r['fast_cycles']}) | {r['smear_kt'] or ''} | "
            f"{r['scf_s']:.2f} | {r['setup_s']:.2f} | {prov} |")
    lines += [
        "",
        f"Converged: **{n_conv}/{len(rows)}** rows; **{n_par}/{n_ref}** "
        f"within {PARITY:g} Eh of the JAX package's rows. Total setup "
        f"{setup:.1f} s, SCF {scf:.1f} s.",
        "",
        "basis column: provenance tiers present (C=canonical, O=optimized,"
        " A=atomic, E=estimated; see basis/data.py).",
    ]
    if errs:
        lines += ["", "## Errors", ""]
        lines += [f"- `{k}`: {v['error']}" for k, v in sorted(errs.items())]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("inp", nargs="?", default=os.path.join(
        ROOT, "docs", "results_58_h100.json"))
    p.add_argument("out", nargs="?", default=os.path.join(
        ROOT, "docs", "RESULTS_h100.md"))
    args = p.parse_args(argv)
    with open(args.inp) as f:
        results = json.load(f)
    with open(REFERENCE) as f:
        reference = json.load(f)
    text = render(results, reference, element_bars())
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
