"""Reference atomic energies and optimized zetas from the JAX package on the
CPU, for the PyTorch port's chip smoke (phase 4h) and zeta-sensitivity
tool to hold their card runs to.

    JAX_PLATFORMS=cpu python tools/atomic_reference.py [OUT.json]

Writes one JSON object (default docs/atomic_reference_cpu.json):

  * energies: basis/atomic_scf.atomic_energy at the table zetas for O, Na,
    Cu, Se, Br, Mo and I, each with its seconds;
  * optimize: optimize_zetas("O") (the optimizer's validation element:
    published 1s 7.66 / 2sp 2.25) and optimize_zetas("Cu",
    frozen_shells=("4sp",)), each with its evaluation trace
    (tools/optimizer_trace.py): every atomic_energy call the optimizer
    made, in order, as (zetas, energy), so a run elsewhere can find the
    first evaluation at which it parts;
  * sensitivity: the central-difference dE/dzeta of
    tools/zeta_sensitivity.py (REL_STEP 0.005) recomputed now for the
    entries of SENSITIVITY, beside the value cached in
    docs/zeta_sensitivity.md.cache.json.

The output is written when each part is done.  Imports JAX; run on the
CPU, never on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

ELEMENTS = ("O", "Na", "Cu", "Se", "Br", "Mo", "I")
OPTIMIZE = (("O", ()), ("Cu", ("4sp",)))
REL_STEP = 0.005   # tools/zeta_sensitivity.py's step
SENS_CACHE = os.path.join(ROOT, "docs", "zeta_sensitivity.md.cache.json")
SENSITIVITY = ("Cu/4sp", "Se/3d")   # entries of SENS_CACHE to recompute


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", default=os.path.join(
        ROOT, "docs", "atomic_reference_cpu.json"))
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from quantum_compute_dft_tpu.basis import atomic_scf
    from quantum_compute_dft_tpu.basis.data import ZETA
    from optimizer_trace import optimize_traced

    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                            capture_output=True, text=True).stdout.strip()
    out = {"command": "JAX_PLATFORMS=cpu python tools/atomic_reference.py",
           "commit": commit or None, "energies": {}, "optimize": {},
           "sensitivity": {}}

    def save():
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)

    t_all = time.time()
    for sym in ELEMENTS:
        zt = {sh: z for sh, (z, _) in ZETA[sym].items()}
        t0 = time.time()
        e = atomic_scf.atomic_energy(sym, zt)
        out["energies"][sym] = {"zetas": zt, "e": e,
                                "seconds": time.time() - t0}
        print(f"{sym}: E = {e:.12f} ({time.time() - t0:.1f} s)", flush=True)
        save()

    for sym, frozen in OPTIMIZE:
        t0 = time.time()
        zetas, e, trace = optimize_traced(atomic_scf, sym,
                                          frozen_shells=frozen)
        out["optimize"][sym] = {"frozen_shells": list(frozen), "sweeps": 4,
                                "zetas": zetas, "e": e, "trace": trace,
                                "seconds": time.time() - t0}
        print(f"optimize {sym}: {zetas} E = {e:.12f} ({len(trace)} "
              f"evaluations, {time.time() - t0:.1f} s)", flush=True)
        save()

    with open(SENS_CACHE) as f:
        cache = json.load(f)
    energy = atomic_scf.atomic_energy
    for key in SENSITIVITY:
        sym, sh = key.split("/")
        zt = {s: z for s, (z, _) in ZETA[sym].items()}
        h = REL_STEP * zt[sh]
        t0 = time.time()
        ep = energy(sym, dict(zt, **{sh: zt[sh] + h}))
        em = energy(sym, dict(zt, **{sh: zt[sh] - h}))
        d = (ep - em) / (2 * h)
        out["sensitivity"][key] = {"dE_dzeta": d, "cached": cache.get(key),
                                   "seconds": time.time() - t0}
        print(f"sensitivity {key}: {d!r} (cache {cache.get(key)!r})",
              flush=True)
        save()
    out["seconds"] = time.time() - t_all
    save()
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
