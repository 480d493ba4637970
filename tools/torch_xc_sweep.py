"""Time every variant of the port's fused XC kernel at one molecule's shape:
the port of tools/pallas_sweep.py.

    python tools/torch_xc_sweep.py [Molecule] [grid_level]
        [--variants K1 K3 ...] [--device cuda]

Prepares the molecule with B3LYP (kohn_sham.prepare, as the JAX tool
does), packs the planes (engine/fused_xc.py::pack_inputs) and takes the
SAD initial density.  For each variant it times the kernel and its plain
PyTorch version with CUDA events (3 warm-up calls, then the median of 25
and their spread) and prints one JSON line: molecule, grid_level, nao,
npad, gpad, v_chunk, variant, calls (kernel calls made for the variant),
ms, ms_min, ms_max, plain_ms, plain_min, plain_max, e_xc, e_xc_plain, gpu
and power_limit (nvidia-smi).

Variants (engine/fused_xc.py's VARIANTS): K1 (the SCF's kernel), K3
(phi_split=True), the ablations nophi, phi3, noprod, nofunc and nov (each
changes one phase of K1, so results are wrong by design; their times
attribute K1's time to its phases) and split2 (reduce="split2", the TPU
kernel's 2-pass row sums).  The JAX tool's DFT_PALLAS_TILE and
DFT_PALLAS_NPAD_GRAN are TPU layout controls with no counterpart in the
tiled CUDA kernels; the line gives the port's V chunk instead.

--device cpu runs the plain versions only, for tests: no time is
measured there (ms fields are null).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from quantum_compute_dft_tpu_torch import kohn_sham  # noqa: E402
from quantum_compute_dft_tpu_torch.engine import fused_xc  # noqa: E402
from quantum_compute_dft_tpu_torch.mol import from_xyz_file  # noqa: E402
from quantum_compute_dft_tpu_torch.scf.driver import initial_guess  # noqa: E402

WARM, REPS = 3, 25


def _cuda_times(fn):
    """(median, min, max) ms of REPS calls after WARM, CUDA events."""
    for _ in range(WARM):
        fn()
    out = []
    for _ in range(REPS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out), min(out), max(out)


def sweep(argv=None) -> list[dict]:
    """Run the sweep and print its lines; returns them."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("molecule", nargs="?", default="DHA")
    p.add_argument("grid_level", nargs="?", type=int, default=3)
    p.add_argument("--variants", nargs="+", choices=list(fused_xc.VARIANTS),
                   default=list(fused_xc.VARIANTS))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("torch_xc_sweep: no CUDA device; --device cpu runs "
                         "the plain versions (tests only)")
    gpu = power = None
    if on_card:
        gpu, power = (x.strip() for x in subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0].split(","))
    dev = torch.device(args.device)
    mol = from_xyz_file(os.path.join(ROOT, "molecules",
                                     args.molecule + ".xyz"))
    setup = kohn_sham.prepare(mol, "B3LYP", grid_level=args.grid_level,
                              device=dev)
    s, fn, n = setup.sys, setup.functional, setup.nao
    aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                          needs_grad=True)
    dm = initial_guess(s)
    npad, gpad = aot.shape
    rows = []
    for name in args.variants:
        kw = fused_xc.VARIANTS[name]

        def kernel():
            return fused_xc.fused_xc(fn, dm, aot, wt, grads, n, **kw)

        def plain():
            return fused_xc.fused_xc_reference(fn, dm, aot, wt, grads, n,
                                               **kw)

        e_xc, e_plain = float(kernel()[0]), float(plain()[0])
        calls = 1
        ms = ms_min = ms_max = pl = pl_min = pl_max = None
        if on_card:
            ms, ms_min, ms_max = _cuda_times(kernel)
            pl, pl_min, pl_max = _cuda_times(plain)
            calls += WARM + REPS
        row = {"molecule": args.molecule, "grid_level": args.grid_level,
               "nao": n, "npad": npad, "gpad": gpad,
               "v_chunk": fused_xc.v_chunk(npad, gpad), "variant": name,
               "calls": calls, "ms": ms, "ms_min": ms_min, "ms_max": ms_max,
               "plain_ms": pl, "plain_min": pl_min, "plain_max": pl_max,
               "e_xc": e_xc, "e_xc_plain": e_plain, "gpu": gpu,
               "power_limit": power}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    sweep()
