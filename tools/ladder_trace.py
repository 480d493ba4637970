"""Trace the annealing ladder of the JAX package and of the PyTorch port
cycle by cycle from the SAME setup arrays, on the CPU, and report where
their energies first part.

    JAX_PLATFORMS=cpu python tools/ladder_trace.py CuO/GGA [--tol 1e-9]

The JAX package's kohn_sham.prepare builds the row's setup (grid level of
tests/golden_energies.json); the port's SCF runs on the same arrays through
kohn_sham.setup_from_arrays.  Both then climb the ladder of
tools/golden_drift.py --ladder (kT 0.5 down to 0.1 from the SAD guess,
mixer adiis+cdiis, each rung warm-started from the package's own previous
rung, stopping at the first that fails).  One JSON line: per rung and
package the convergence and cycles, and the first cycle (rung, cycle of the
rung, cycle of the whole ladder) at which |E_jax - E_port| > tol, with the
gaps of the cycles around it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def trace(key: str, tol: float = 1e-9) -> dict:
    import numpy as np

    from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
    from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
    from quantum_compute_dft_tpu.basis.basis_set import (
        sad_occupations as jax_sad_occupations,
    )
    from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz
    from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host
    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.scf.driver import ANNEAL_KTS, scf_host

    mol_name, fn = key.split("/")
    with open(os.path.join(ROOT, "tests", "golden_energies.json")) as f:
        row = next(r for r in json.load(f)["rows"]
                   if r["molecule"] == mol_name and r["functional"] == fn)
    jmol = jax_from_xyz(os.path.join(ROOT, "molecules", mol_name + ".xyz"))
    js = jax_kohn_sham.prepare(jmol, fn, grid_level=row["grid_level"])
    s = js.sys
    sad = jax_sad_occupations(jax_build_basis(jmol), jmol.charges, jmol.nelec)
    ps = kohn_sham.setup_from_arrays(
        np.asarray(s.hcore), np.asarray(s.s), np.asarray(s.eri),
        np.asarray(s.ao), None if s.ao_grad is None else np.asarray(s.ao_grad),
        np.asarray(s.weights), s.e_nuc, s.nocc, s.nopen, sad, fn,
        device="cpu")
    runners = {
        "jax": lambda **kw: jax_scf_host(js.sys, js.functional, **kw),
        # the JAX package's GGA potential (jax_potential), as its loop's
        "port": lambda **kw: scf_host(ps.sys, ps.functional.jax_potential(),
                                      **kw)}

    rungs = {name: [] for name in runners}
    energies = {name: [] for name in runners}   # per rung: [e per cycle]
    for name, run in runners.items():
        dm0 = None
        for kt in ANNEAL_KTS:
            es = []
            r = run(smear_kt=kt, dm0=dm0, mixer="adiis+cdiis",
                    callback=lambda c, eb, de, dn: es.append(float(eb.e_tot)))
            rungs[name].append({"kt": kt, "converged": bool(r.converged),
                                "n": r.n_iter, "e_tot": float(r.e_tot)})
            energies[name].append(es)
            if not r.converged:
                break
            dm0 = np.asarray(r.dm)
    out = {"row": key, "tol": tol, "jax": rungs["jax"], "port": rungs["port"],
           "first_parting": None}
    total = 0
    for i, (ej, ep) in enumerate(zip(energies["jax"], energies["port"])):
        n = min(len(ej), len(ep))
        gaps = [abs(a - b) for a, b in zip(ej[:n], ep[:n])]
        over = [c for c, g in enumerate(gaps) if g > tol]
        if over:
            c = over[0]
            out["first_parting"] = {
                "rung_kt": ANNEAL_KTS[i], "rung_cycle": c + 1,
                "ladder_cycle": total + c + 1,
                "gap": gaps[c],
                "gaps_before": gaps[max(0, c - 5):c],
                "gaps_after": gaps[c + 1:c + 11],
                "max_gap_first_20": max(gaps[:20]) if gaps else None}
            break
        total += n
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("rows", nargs="+", help="MOL/FN of tests/golden_energies.json")
    p.add_argument("--tol", type=float, default=1e-9)
    args = p.parse_args(argv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for key in args.rows:
            print(json.dumps(trace(key, args.tol)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
