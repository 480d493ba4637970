"""Reference energies of the RI auxiliary tiers from the JAX package on the
CPU, for the PyTorch port's chip smoke (phase 4d) to hold its card runs to.

    JAX_PLATFORMS=cpu python tools/ri_reference.py [Molecule]
        [--functional B3LYP] [--grid-level 3] [--tiers tight fast]
        [--out docs/ri_reference_cpu.json]

For each tier the JAX package builds the tier's 3-center and 2-center
integrals (integrals/density_fitting.py::df_tensors) and its K factor
B = j3c V^(-1/2) (make_df_builders, f64).  Two SCFs (scf_host, f64) then
run on its kohn_sham.prepare at the grid level:

  * e_tot: prepare(_df_override=(B, None)), J = B (B^T D) and K over B,
    converged to ||dD|| < 1e-9 and |dE| < 1e-11: the tier's fixed-point
    energy, the one the port computes (its RI J is B (B^T D));
  * e_tot_robust_fit: prepare(_df_override=(j3c, v2c)), the JAX package's
    own RI J, the robust fit j3c V^+ (j3c^T D), on the default rule.  V^+
    has entries to ~1e5-1e6 for these metrics (condition up to 1e9 at
    lindep 1e-9), and forming it costs J up to ~1e-8 of its size (H2O
    tight: 7e-9), which moves this energy by up to ~1e-6 Eh and keeps the
    loop from converging to ||dD|| < 1e-9: it is printed beside e_tot, not
    used as the reference.

Each row, with the command and commit that made it, goes into --out as
soon as its tier is done, replacing the row of the same molecule, grid
level and tier (runs of one tier each may write one file).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TIGHT = {"conv_tol_d": 1e-9, "conv_tol_e": 1e-11}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("molecule", nargs="?", default="Decane")
    p.add_argument("--functional", default="B3LYP")
    p.add_argument("--grid-level", type=int, default=3)
    p.add_argument("--tiers", nargs="+", choices=("tight", "fast"),
                   default=["tight", "fast"])
    p.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                 "ri_reference_cpu.json"))
    args = p.parse_args(argv)

    import jax.numpy as jnp
    import numpy as np

    from quantum_compute_dft_tpu import kohn_sham
    from quantum_compute_dft_tpu.basis import build_basis
    from quantum_compute_dft_tpu.integrals import density_fitting as df
    from quantum_compute_dft_tpu.mol import from_xyz_file
    from quantum_compute_dft_tpu.scf.driver import scf_host

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    command = ("JAX_PLATFORMS=cpu python tools/ri_reference.py "
               + " ".join(sys.argv[1:] if argv is None else argv))
    mol = from_xyz_file(os.path.join(ROOT, "molecules",
                                     args.molecule + ".xyz"))
    for tier in args.tiers:
        t0 = time.time()
        j3c, v2c = df.df_tensors(build_basis(mol), mol, aux_level=tier)
        j3c, v2c = np.asarray(j3c), np.asarray(v2c)
        t_df = time.time() - t0
        v_pinv, _ = df.metric_factors(v2c)
        _, _, b64 = df.make_df_builders(jnp.asarray(j3c), v2c,
                                        k_dtype="float64")
        b64 = np.asarray(b64)
        row = {"molecule": args.molecule, "functional": args.functional,
               "grid_level": args.grid_level, "tier": tier,
               "naux": int(v2c.shape[0]),
               "naux_kept": int(round(np.trace(v_pinv @ v2c))),
               "df_tensors_s": t_df}
        for key, override, kw in (("", (b64, None), TIGHT),
                                  ("_robust_fit", (j3c, v2c), {})):
            setup = kohn_sham.prepare(mol, args.functional,
                                      grid_level=args.grid_level,
                                      _df_override=override)
            r = scf_host(setup.sys, setup.functional, **kw)
            row.update({f"e_tot{key}": float(r.e_tot),
                        f"converged{key}": bool(r.converged),
                        f"n_iter{key}": int(r.n_iter)})
        row.update(seconds=time.time() - t0, command=command, commit=commit)
        print(json.dumps(row), flush=True)
        _store(args.out, row)
    return 0


def _store(path: str, row: dict) -> None:
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)["rows"]
    key = ("molecule", "functional", "grid_level", "tier")
    rows = [r for r in rows if [r[k] for k in key] != [row[k] for k in key]]
    with open(path, "w") as f:
        json.dump({"rows": rows + [row]}, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
