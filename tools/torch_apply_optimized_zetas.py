"""Write a zeta_optimized.py module from an optimizer results JSON.

    python tools/torch_apply_optimized_zetas.py RESULTS.json OUT_MODULE.py

The port of tools/apply_optimized_zetas.py.  RESULTS.json is
tools/torch_optimize_heavy_zetas.py's output: one entry per element
{"zetas": {shell: zeta}, "e_opt": .., "e_table": .., "frozen": shell}
(its "header" entry and the elements that failed are skipped).  Shells
listed in "frozen" were held at their molecular-convention table values
and are written at those values: holding them is a step of the
derivation, so the element's provenance tier is 'optimized' as a whole.

OUT_MODULE.py is required and has no default: the port's shipped table
(quantum_compute_dft_tpu_torch/basis/zeta_optimized.py) must stay the
JAX package's, or every golden energy moves.  When OUT_MODULE.py exists,
its OPTIMIZED table is read (as text, not imported) and merged with the
new elements, so an incremental run keeps the elements of an earlier one.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

HEADER = '''"""Variationally optimized STO-3G zetas (GENERATED).

Written by tools/torch_apply_optimized_zetas.py from a run of
quantum_compute_dft_tpu_torch/basis/atomic_scf.optimize_zetas
(tools/torch_optimize_heavy_zetas.py): spherically-averaged,
spin-resolved atomic-HF energy minimization over each element's shell
zetas, the derivation procedure behind the published STO-3G tables.
Metal valence shells (Sc-Zn 4sp, Rb-Cd 5sp) are held at their
molecular-convention table values and written at those values.
Provenance tier: 'optimized'.
"""

'''


def read_table(path: str) -> dict[str, dict[str, float]]:
    """The OPTIMIZED dict of a generated module, read from its source."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        target = getattr(node, "target", None) or (
            node.targets[0] if isinstance(node, ast.Assign) else None)
        if isinstance(target, ast.Name) and target.id == "OPTIMIZED":
            return ast.literal_eval(node.value)
    raise ValueError(f"{path} defines no OPTIMIZED table")


def apply(results_path: str, out_path: str) -> dict:
    """Merge the results into out_path's table and write it -> the table."""
    with open(results_path) as f:
        data = json.load(f)
    out = read_table(out_path) if os.path.exists(out_path) else {}
    for sym, row in data.items():
        if sym == "header":
            continue
        if "error" in row:
            print(f"skip {sym}: {row['error']}")
            continue
        out[sym] = dict(row["zetas"])  # frozen shells included (see above)
    with open(out_path, "w") as f:
        f.write(HEADER)
        f.write("OPTIMIZED: dict[str, dict[str, float]] = {\n")
        for sym in sorted(out):
            f.write(f"    {sym!r}: {out[sym]!r},\n")
        f.write("}\n")
    print(f"wrote {out_path} ({len(out)} elements)")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", help="tools/torch_optimize_heavy_zetas.py JSON")
    p.add_argument("out_module", help="the module to write (required)")
    args = p.parse_args(argv)
    apply(args.results, args.out_module)
    return 0


if __name__ == "__main__":
    sys.exit(main())
