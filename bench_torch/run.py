"""Runs one cell of the port's benchmark once and prints its result line.

    python bench_torch/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Needs a CUDA card: without one it exits 2 and prints no result.  The
last line of stdout is one JSON object: correct, attempted, failed, the
cell's end-to-end metrics (--trace 0) or per-layer metrics (--trace 1),
the device, the parts of set-up (a checkout's first run builds the
kernel library and the bytecode: ``kernels_built``, ``bytecode_built``),
and last the numbers compared with their limits, which are also the last
lines on stderr.

    python bench_torch/run.py --rehearse --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

rehearses the same run on the CPU with H2O at grid level 1
(``rehearsal/h2o.sto3g.grid1.json``) and prints its numbers under
"rehearsal" only: they are CPU numbers, never device metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# bytecode of every module this process imports (torch's too) is kept in
# the checkout, so only a checkout's first run compiles it
sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
BYTECODE_BUILT = not os.path.isdir(sys.pycache_prefix)
sys.dont_write_bytecode = False
REHEARSAL_CONFIG = os.path.join(HERE, "rehearsal", "h2o.sto3g.grid1.json")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="run on the CPU at H2O grid 1; prints no metrics")
    return p.parse_args(argv)


JAX_MODULES = ("jax", "jaxlib", "flax", "quantum_compute_dft_tpu")


def jax_loaded() -> list:
    """Modules of JAX, jaxlib, Flax or the JAX package that this process
    imported, matched by their whole top-level name."""
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in JAX_MODULES)


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.splitlines()[0].strip() if out.strip() else None


def main(argv=None) -> int:
    args = parse(argv)
    if not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        print("BENCHMARK.json not found beside bench_torch/", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    device = "cpu" if args.rehearse else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only "
              "(--rehearse runs the CPU rehearsal)", file=sys.stderr)
        return 2
    os.environ.setdefault("DFT_MOLECULES_DIR", os.path.join(HERE, "molecules"))
    from bench_torch import harness

    res = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), T_START, device=device,
                      config_path=REHEARSAL_CONFIG if args.rehearse else None)
    bad = jax_loaded()
    if bad:
        print(f"JAX was imported: {bad[:5]}", file=sys.stderr)
        return 3
    for k, v in res["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    if args.rehearse:
        print(json.dumps({"rehearsal": {
            "device": "cpu", "correct": res["correct"],
            "attempted": res["attempted"], "failed": res["failed"],
            "cpu_numbers": {k: v["value"] for k, v in res["metrics"].items()},
            "references": res["references"],
            "compared": res["compared"]}}))
        return 0
    dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=1,
               memory_peak_bytes=res["peak"], power_limit=power_limit())
    line = dict(correct=res["correct"], attempted=res["attempted"],
                failed=res["failed"], metrics=res["metrics"], device=dev)
    if args.trace:
        prof = res["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = dict(
            device_ops=[list(kv) for kv in prof["device_ops"]],
            idle_gaps=[list(kv) for kv in prof["idle_gaps"]])
    # the one-off costs of a checkout's first run, apart from setup_s's
    line["setup_parts"] = dict(res["setup_parts"],
                               bytecode_built=BYTECODE_BUILT)
    line["compared"] = res["compared"]
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
