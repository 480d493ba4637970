"""Re-converge rows of tests/golden_energies.json with today's JAX package
and with the PyTorch port, both on the CPU, and print how far each lands
from the table.

    JAX_PLATFORMS=cpu python tools/golden_drift.py [--ladder | --fast]
        HCl/LDA [MOL/FN ...]

For each row, one JSON line: the table's energy and cycles; the JAX
package's scf_host (kohn_sham.prepare at the row's grid level, f64, the
generator's integer-occupation call) with its cycles and difference from
the table, and the same converged to ||dD|| < 1e-9 and |dE| < 1e-11 (the
fixed point's energy); the port's scf_host on its own setup, the same two
ways.  A row where the JAX package itself misses the table, by as much as
the port, has drifted from the code that made the table
(tools/gen_golden.py), not from the port.

--ladder: the rungs of the annealing ladder instead (kT 0.5 down to 0.1
from the SAD guess, ADIIS then CDIIS, each rung warm-started from the
last, stopping at the first that fails), in both packages: each rung's
kT, convergence, cycles and energy.

--fast: the 'fast' schedule instead, from the SAD guess with integer
occupations: the JAX package's scf_host_staged(xc_impl='fast') with its
Pallas kernel in interpret mode (DFT_PALLAS_INTERPRET=1), and the port's
scf_host(xc_impl='fast') with the fused kernel's plain version.  For each:
convergence, cycles (the port's split into kernel-phase and f64 verify
cycles), energy and its difference from the table, and the last 8 cycles'
||dD||.  Progress goes to stderr every 10 cycles, so a run cut short
still says how far it got.
"""

from __future__ import annotations

import json
import os
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TIGHT = {"conv_tol_d": 1e-9, "conv_tol_e": 1e-11}


def _runners(key: str, table: dict, with_jax_setup: bool = False):
    """(table row, {"jax": scf_host of the JAX package's setup, "port":
    scf_host of the port's own setup on the CPU}), each taking scf_host's
    keywords; with_jax_setup adds the JAX package's KSSetup itself under
    "jax_setup"."""
    from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
    from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz
    from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host
    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    mol, fn = key.split("/")
    row = table[(mol, fn)]
    path = os.path.join(ROOT, "molecules", mol + ".xyz")
    js = jax_kohn_sham.prepare(jax_from_xyz(path), fn,
                               grid_level=row["grid_level"])
    ps = kohn_sham.prepare(from_xyz_file(path), fn,
                           grid_level=row["grid_level"], device="cpu",
                           cd_tol=kohn_sham.CD_TOL)
    runners = {
        "jax": lambda **kw: jax_scf_host(js.sys, js.functional, **kw),
        # the JAX package's GGA potential (jax_potential), as the table's
        "port": lambda **kw: scf_host(ps.sys, ps.functional.jax_potential(),
                                      **kw)}
    if with_jax_setup:
        runners["jax_setup"] = js
    return row, runners


def drift(key: str, table: dict) -> dict:
    row, runners = _runners(key, table)
    out = {"row": key, "e_table": row["e_tot"], "n_table": row["n_iter"],
           "smear_kt_table": row["smear_kt"]}
    for name, run in runners.items():
        r, rt = run(), run(**TIGHT)
        out.update({f"{name}_converged": bool(r.converged),
                    f"{name}_n": r.n_iter,
                    f"{name}_de": float(r.e_tot) - row["e_tot"],
                    f"{name}_tight_converged": bool(rt.converged),
                    f"{name}_tight_de": float(rt.e_tot) - row["e_tot"]})
    return out


def ladder(key: str, table: dict) -> dict:
    from quantum_compute_dft_tpu_torch.scf.driver import ANNEAL_KTS

    row, runners = _runners(key, table)
    out = {"row": key, "e_table": row["e_tot"],
           "smear_kt_table": row["smear_kt"]}
    for name, run in runners.items():
        rungs, dm0 = [], None
        for kt in ANNEAL_KTS:
            r = run(smear_kt=kt, dm0=dm0, mixer="adiis+cdiis")
            rungs.append({"kt": kt, "converged": bool(r.converged),
                          "n": r.n_iter, "e_tot": float(r.e_tot)})
            if not r.converged:
                break
            dm0 = r.dm
        out[name] = rungs
    return out


def _interpret_pallas():
    """Run the JAX package's Pallas kernel in interpret mode on the CPU,
    as tests/test_pallas.py does."""
    os.environ["DFT_PALLAS_INTERPRET"] = "1"
    import quantum_compute_dft_tpu.engine.pallas_xc as px

    orig = px.pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    px.pl.pallas_call = patched


def fast(key: str, table: dict) -> dict:
    from quantum_compute_dft_tpu.scf.driver import (
        scf_host_staged as jax_scf_host_staged,
    )

    _interpret_pallas()
    row, runners = _runners(key, table, with_jax_setup=True)
    out = {"row": key, "e_table": row["e_tot"], "n_table": row["n_iter"]}
    for name in ("port", "jax"):
        dns = []

        def cb(cycle, eb, de, dnorm, name=name):
            dns.append(float(dnorm))
            if (cycle + 1) % 10 == 0:
                print(f"{key} {name}: cycle {cycle + 1} dE {float(de):+.3e} "
                      f"||dD|| {float(dnorm):.3e}", file=sys.stderr,
                      flush=True)

        if name == "port":
            r = runners["port"](xc_impl="fast", callback=cb)
            out.update(port_fast_cycles=r.fast_cycles,
                       port_verify_cycles=r.verify_cycles)
        else:
            js = runners["jax_setup"]
            r = jax_scf_host_staged(js.sys, js.functional, xc_impl="fast",
                                    callback=cb)
        out.update({f"{name}_converged": bool(r.converged),
                    f"{name}_n": r.n_iter,
                    f"{name}_e": float(r.e_tot),
                    f"{name}_de": float(r.e_tot) - row["e_tot"],
                    f"{name}_last_dnorms": dns[-8:]})
    return out


def main(argv=None):
    keys = sys.argv[1:] if argv is None else argv
    fn = drift
    if keys and keys[0] in ("--ladder", "--fast"):
        keys, fn = keys[1:], {"--ladder": ladder, "--fast": fast}[keys[0]]
    with open(os.path.join(ROOT, "tests", "golden_energies.json")) as f:
        table = {(r["molecule"], r["functional"]): r
                 for r in json.load(f)["rows"]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for key in keys:
            print(json.dumps(fn(key, table)), flush=True)


if __name__ == "__main__":
    main()
