"""Search rescue protocols for ABAQ/B3LYP on the card and record each one:
the runs behind docs/rescue_h100.json.

    python tools/torch_rescue_search.py OUT.json [NAME ...]

Each protocol of PROTOCOLS (or only the NAMEs given; the table is tuned
for MOLECULE) runs tools/torch_rescue_ladder.py's rescue_system on MOLECULE
(B3LYP) at its grid level with its RESCUE_* knobs, in this process, one
kohn_sham.prepare per grid level.  A protocol with "dm0_from" starts from
the final density of that earlier protocol of the same run (what
RESCUE_SAVE_DM / RESCUE_DM0 chain between two runs of the tool).  Every
SCF run of the protocol (each ladder rung, the integer finish, the
re-tighten) is logged with its kT, convergence, cycles, energy and
seconds.  One JSON row a protocol is printed and OUT is rewritten after
each: the knobs, the runs, the end state (converged, kT, cycles, e_tot,
its difference from the JAX package's record, docs/results_58.json),
seconds, and the card's name and power limit (nvidia-smi).  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import torch  # noqa: E402
import torch_rescue_ladder as rescue  # noqa: E402

from quantum_compute_dft_tpu_torch import kohn_sham  # noqa: E402
from quantum_compute_dft_tpu_torch.mol import from_xyz_file  # noqa: E402
from quantum_compute_dft_tpu_torch.scf.driver import (  # noqa: E402
    scf_host,
    scf_host_annealed,
)

RECORD = os.path.join(ROOT, "docs", "results_58.json")
MOLECULE = "ABAQ"
COLD = "0.5,0.35,0.25,0.2,0.15,0.1,0.075,0.05,0.035,0.025,0.02,0.015"
BELOW_01 = "0.1,0.075,0.05,0.035,0.025,0.02,0.015"
# name -> (grid level, RESCUE_* knobs, protocol whose final density starts
# this one, or None for SAD)
PROTOCOLS = {
    "g1-mix0.1": (1, {"RESCUE_XC": "f64", "RESCUE_MIXER": "mix+cdiis",
                      "RESCUE_ALPHA": "0.1", "RESCUE_KTS": COLD,
                      "RESCUE_MAX_CYCLE": "400"}, None),
    "g1-adiis-loose": (1, {"RESCUE_XC": "f64", "RESCUE_MIXER": "adiis+cdiis",
                           "RESCUE_KTS": COLD, "RESCUE_MAX_CYCLE": "300",
                           "RESCUE_RUNG_TOL_D": "1e-4",
                           "RESCUE_RUNG_TOL_E": "1e-6"}, None),
    "g3-from-g1-cdiis": (3, {"RESCUE_XC": "f64", "RESCUE_KTS": "0.015",
                             "RESCUE_MAX_CYCLE": "300"}, "g1-mix0.1"),
    "g3-from-g1-mix": (3, {"RESCUE_XC": "f64", "RESCUE_MIXER": "mix+cdiis",
                           "RESCUE_ALPHA": "0.2",
                           "RESCUE_KTS": "0.05,0.035,0.025,0.02,0.015",
                           "RESCUE_MAX_CYCLE": "300"}, "g1-mix0.1"),
    "g3-mix0.1": (3, {"RESCUE_XC": "f64", "RESCUE_MIXER": "mix+cdiis",
                      "RESCUE_ALPHA": "0.1", "RESCUE_KTS": COLD,
                      "RESCUE_MAX_CYCLE": "400"}, None),
    "g3-adiis-loose": (3, {"RESCUE_XC": "f64", "RESCUE_MIXER": "adiis+cdiis",
                           "RESCUE_KTS": COLD, "RESCUE_MAX_CYCLE": "300",
                           "RESCUE_RUNG_TOL_D": "1e-4",
                           "RESCUE_RUNG_TOL_E": "1e-6"}, None),
    "g3-mix0.2-loose": (3, {"RESCUE_XC": "f64", "RESCUE_MIXER": "mix+cdiis",
                            "RESCUE_ALPHA": "0.2", "RESCUE_KTS": COLD,
                            "RESCUE_MAX_CYCLE": "300",
                            "RESCUE_RUNG_TOL_D": "1e-4",
                            "RESCUE_RUNG_TOL_E": "1e-6"}, None),
    "g3-cdiis-cold": (3, {"RESCUE_XC": "f64", "RESCUE_KTS": BELOW_01,
                          "RESCUE_MAX_CYCLE": "300"}, None),
}


def _record_energy():
    with open(RECORD) as f:
        return json.load(f)[f"{MOLECULE}/B3LYP"]["e_tot"]


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


def run_protocol(setup, knobs: dict, dm0=None):
    """One protocol on a prepared setup -> (result or None, the ladder's
    own result, whose density RESCUE_SAVE_DM would save, runs)."""
    runs, ladder = [], []

    def logged(sys_, functional, **kw):
        t0 = time.time()
        # the JAX package's GGA potential (jax_potential), as rescue_system's
        r = scf_host(sys_, functional.jax_potential(), **kw)
        torch.cuda.synchronize()
        runs.append({"kt": kw.get("smear_kt", 0.0), "converged": r.converged,
                     "cycles": r.n_iter, "e_tot": r.e_tot,
                     "seconds": time.time() - t0})
        print(f"    kT={runs[-1]['kt']:g} converged={r.converged} cycles="
              f"{r.n_iter} E={r.e_tot:.10f} ({runs[-1]['seconds']:.2f} s)",
              flush=True)
        return r

    def annealed(sys_, functional, **kw):
        if dm0 is not None:  # RESCUE_DM0's part, handed over in process
            kw["dm0"] = dm0
        ladder.append(scf_host_annealed(sys_, functional, **kw))
        return ladder[-1]

    r = rescue.rescue_system(setup.sys, setup.functional, env=dict(knobs),
                             annealed_fn=annealed, runner=logged)
    return r, ladder[0], runs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out")
    p.add_argument("names", nargs="*", default=list(PROTOCOLS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_rescue_search: no CUDA device")
    card = _card()
    e_rec = _record_energy()
    mol = from_xyz_file(os.path.join(ROOT, "molecules", MOLECULE + ".xyz"))
    setups, final_dm, rows = {}, {}, []
    unknown = set(args.names) - set(PROTOCOLS)
    if unknown:
        raise SystemExit(f"unknown protocols {sorted(unknown)}")
    for name in args.names:
        level, knobs, start = PROTOCOLS[name]
        if level not in setups:
            t0 = time.time()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                setups[level] = kohn_sham.prepare(mol, "B3LYP",
                                                  grid_level=level,
                                                  device="cuda",
                                                  cd_tol=kohn_sham.CD_TOL)
            print(f"  prepare grid {level}: {time.time() - t0:.2f} s",
                  flush=True)
        if start is not None and start not in final_dm:
            raise SystemExit(f"{name} starts from {start}, which has not "
                             "run in this call")
        print(f"{name}: grid {level} {knobs}"
              + (f" from {start}" if start else ""), flush=True)
        t0 = time.time()
        r, ladder, runs = run_protocol(setups[level], knobs,
                                       final_dm.get(start))
        seconds = time.time() - t0
        final_dm[name] = ladder.dm
        e_end = (r if r is not None else ladder).e_tot
        row = {"name": name, "molecule": MOLECULE, "functional": "B3LYP",
               "grid_level": level, "knobs": knobs, "dm0_from": start,
               "runs": runs, "converged": r is not None and r.converged,
               "smear_kt": None if r is None else r.smear_kt,
               "cycles": sum(x["cycles"] for x in runs), "e_tot": e_end,
               "de_record": None if e_end is None else e_end - e_rec,
               "seconds": seconds, "device": "cuda", "card": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"record_e_tot": e_rec, "rows": rows}, f, indent=1)
        os.replace(tmp, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
