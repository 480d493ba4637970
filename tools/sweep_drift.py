"""Run a row of the molecule sweep (tools/torch_run_all_molecules.py
without --golden) through today's JAX package and through the PyTorch
port, both on the CPU, as tools/golden_drift.py does for the golden rows.

    JAX_PLATFORMS=cpu python tools/sweep_drift.py MOL/FN ... [--grid-level 3]

The annealing ladder's rungs of each package (golden_drift.ladder: kT 0.5
down to 0.1 from the SAD guess, ADIIS then CDIIS, stopping at the first
rung that fails), for the sweep rows whose integer attempt fails.  One
JSON line per row.  A row that both packages fail the same way is the
reference's behaviour, not a port fault.  Above ~nao 80 take --grid-level
1: the JAX package compiles its SCF with the AO planes as constants, which
at grid 3 took over 14 GB and ten minutes on the CPU (ABAQ, nao 105)
without finishing.  Imports JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("rows", nargs="+", help="MOL/FN")
    p.add_argument("--grid-level", type=int, default=3)
    args = p.parse_args(argv)

    import golden_drift

    # golden_drift reads a table row's grid level and energy: a sweep row
    # has no reference energy here, so its differences print as nan
    table = {tuple(k.split("/")): {"grid_level": args.grid_level,
                                   "e_tot": math.nan, "n_iter": None,
                                   "smear_kt": None} for k in args.rows}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for key in args.rows:
            out = golden_drift.ladder(key, table)
            print(json.dumps(dict(out, grid_level=args.grid_level)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
