"""ABAQ/B3LYP's integer-occupation finish from a saved smeared density, in
the JAX package and in the PyTorch port, both on the CPU.

    JAX_PLATFORMS=cpu python tools/rescue_integer_finish.py DM.npy OUT.json

DM.npy is a kT 0.015 density that tools/torch_rescue_ladder.py saved with
RESCUE_SAVE_DM (the chain of docs/rescue_h100.json).  Each package's
scf_host (f64, density-fitted as the sweep, B3LYP) runs three times on its
own setup at grid level 1: kT 0.015 with CDIIS from DM (is DM the same
smeared state in both), then from that run's density the integer finish
that scf_host_annealed makes (smear_kt 0, at most 100 cycles) with CDIIS
and with the protocol's mixer (mix+cdiis, alpha 0.2).  One JSON line a
run (package, what, kT, mixer, converged, cycles, e_tot, seconds), and
OUT holds them all with the JAX package's record (docs/results_58.json,
grid 3).  Grid level 1, because the JAX package compiles its SCF with the
AO planes as constants, which at grid 3 outgrows a CPU host
(tools/sweep_drift.py).  Imports JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MOLECULE = "ABAQ"
GRID_LEVEL = 1
KT = 0.015
FINISH_MAX_CYCLE = 100  # scf_host_annealed's integer finish
# what -> (kT, mixer); the finishes start from the kT run's density
RUNS = (("smeared", KT, "cdiis"), ("integer", 0.0, "cdiis"),
        ("integer", 0.0, "mix+cdiis"))


def _runners():
    """{"jax": scf_host on the JAX package's setup, "port": the port's
    scf_host on its own setup on the CPU}, each taking scf_host's keywords
    and returning (converged, cycles, e_tot, dm as numpy)."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
    from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz
    from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host
    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    path = os.path.join(ROOT, "molecules", MOLECULE + ".xyz")
    js = jax_kohn_sham.prepare(jax_from_xyz(path), "B3LYP",
                               grid_level=GRID_LEVEL)
    ps = kohn_sham.prepare(from_xyz_file(path), "B3LYP",
                           grid_level=GRID_LEVEL, device="cpu",
                           cd_tol=kohn_sham.CD_TOL)

    def jax_run(dm0, **kw):
        r = jax_scf_host(js.sys, js.functional, dm0=dm0, **kw)
        return bool(r.converged), r.n_iter, float(r.e_tot), np.asarray(r.dm)

    def port_run(dm0, **kw):
        # with the JAX package's GGA potential (jax_potential), so that the
        # two packages run the same SCF
        r = scf_host(ps.sys, ps.functional.jax_potential(),
                     dm0=torch.as_tensor(dm0), **kw)
        return bool(r.converged), r.n_iter, float(r.e_tot), r.dm.numpy()

    return {"jax": jax_run, "port": port_run}, (js.nao, js.ngrid)


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dm")
    p.add_argument("out")
    args = p.parse_args(argv)
    dm_saved = np.load(args.dm)
    with open(os.path.join(ROOT, "docs", "results_58.json")) as f:
        record = json.load(f)[f"{MOLECULE}/B3LYP"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        runners, (nao, ngrid) = _runners()
        rows = []
        for package, run in runners.items():
            dm_kt = None
            for what, kt, mixer in RUNS:
                t0 = time.time()
                kw = {"smear_kt": kt, "mixer": mixer}
                if what == "integer":
                    kw["max_cycle"] = FINISH_MAX_CYCLE
                conv, n, e, dm = run(dm_saved if dm_kt is None else dm_kt,
                                     **kw)
                if what == "smeared":
                    dm_kt = dm
                rows.append({"package": package, "what": what, "kt": kt,
                             "mixer": mixer, "converged": conv,
                             "cycles": n, "e_tot": e,
                             "seconds": time.time() - t0})
                print(json.dumps(rows[-1]), flush=True)
    out = {"molecule": MOLECULE, "functional": "B3LYP",
           "grid_level": GRID_LEVEL, "nao": nao, "ngrid": ngrid,
           "dm": os.path.basename(args.dm), "record": record["e_tot"],
           "rows": rows}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
