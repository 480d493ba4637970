"""Readings for the limit of a cell's energy comparison: the program on
its timed path and its own lower-precision path, both held to the plain
reference, over many seeds in one process.

    python bench_torch/control.py --workload <name> --seeds 1 2 3 \
        [--control-seeds 1 2 3] [--out FILE]

For each seed: one round of the cell's own jobs (the `fast` schedule, as
timed), then for the control seeds the same jobs with `--xc-impl pallas`
(every cycle's XC and the reported energy on the fused f32 kernel, the
program's own lower-precision path), then the reference at the seed's
geometry.  Prints one JSON line per seed with each functional's gap (Eh)
of the program and of the control.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from bench_torch import harness  # noqa: E402


class PallasJobs(harness.Jobs):
    """The cell's jobs on the program's f32 path (`--xc-impl pallas`)."""

    def argv(self, functional, path):
        args = super().argv(functional, path)
        i = args.index("--xc-impl")
        return args[:i + 1] + ["pallas"] + args[i + 2:]


def readings(workload: str, seed: int, control: bool, device: str,
             config_path: str | None = None) -> dict:
    import torch

    c = harness.cell(workload)
    config = harness.load_json(config_path) if config_path else c["config"]
    traffic = c["traffic"]
    out = dict(workload=workload, seed=seed)
    with tempfile.TemporaryDirectory(prefix="bench_torch_ctl_") as scratch:
        syms, xyz = harness.seeded_geometry(
            os.path.join(harness.ROOT, config["molecule"]), seed)
        paths = [os.path.join(scratch, "molecule.xyz")]
        harness.write_xyz(paths[0], syms, xyz)
        energies = {}
        runs = [("program", harness.Jobs)]
        if control:
            runs.append(("control", PallasJobs))
        for label, cls in runs:
            recs = cls(config, traffic, paths, device, scratch).round()
            energies[label] = {r["functional"]: r.get("e_tot") for r in recs}
            out[label + "_ok"] = all(r["ok"] for r in recs)
            out[label + "_errors"] = [r["error"] for r in recs
                                      if "error" in r]
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        ref = harness.reference_energies(config, traffic["functionals"], syms,
                                         xyz, device)
    for fn, e_ref in ref.items():
        out[f"reference_{fn}"] = e_ref
        for label, es in energies.items():
            if es.get(fn) is not None:
                out[f"{label}_gap_{fn}"] = abs(es[fn] - e_ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--config", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        row = readings(args.workload, seed, seed in args.control_seeds,
                       args.device, args.config)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
