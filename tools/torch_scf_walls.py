"""Warm wall times of the port's fast SCF, in one process, for one checkout:
the end-to-end A/B of two trees on one card.

    python tools/torch_scf_walls.py [TREE]

TREE (default: this checkout) is the root of a checkout of the repo whose
``quantum_compute_dft_tpu_torch`` is imported; unpack another commit into
a directory that .gitignore lists (``git archive <commit> | tar -x -C
build/parent``) and run both trees in one call, in turns (parent, change,
change, parent).  Runs Benzene/PBE once to build the kernels and warm up
(its time is dropped), then DHA/B3LYP and Benzene/PBE three times each, through
the CLI entry (``cli.run``, --xc-impl fast, grid level 3), and prints one
JSON line per run: tree, functional, molecule, SCF seconds (host clock
around the loop, ending in a sync), cycles, kernel-phase cycles, energy,
and the card's name and power limit.  Needs a CUDA GPU.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("GGA", "Benzene", 1, False), ("B3LYP", "DHA", 3, True),
        ("GGA", "Benzene", 3, True))


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    tree = os.path.abspath(args[0] if args else HERE)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_scf_walls: no CUDA device")
    from quantum_compute_dft_tpu_torch import cli

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    for fn, mol, reps, keep in RUNS:
        for _ in range(reps):
            with contextlib.redirect_stdout(io.StringIO()):
                _, res, scf_s = cli.run([
                    fn, mol, "--molecules-dir", os.path.join(HERE, "molecules"),
                    "--grid-level", "3", "--xc-impl", "fast"])
            torch.cuda.synchronize()
            if keep:
                print(json.dumps({
                    "tree": os.path.relpath(tree, HERE), "functional": fn,
                    "molecule": mol, "scf_s": scf_s, "cycles": res.n_iter,
                    "kernel_cycles": res.fast_cycles, "e_tot": res.e_tot,
                    "gpu": gpu}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
