"""Converge the 117-atom north star on one GPU through the PyTorch port.

    python tools/torch_northstar.py [--xc-impl fast f64] [--resume]
        [--mol C33H56N7O17P3S] [--cd-tol 1e-5] [--grid-level 1]
        [--max-cycle 400] [--out docs/northstar_h100.json]

The port of tools/northstar_cache.py and tools/northstar_singlechip.py in
one tool.  Defaults are the recorded L1 run of the JAX package
(docs/northstar_singlechip_L1.json): C33H56N7O17P3S, B3LYP, grid level 1,
a pivoted-Cholesky factor at tol 1e-5, max_cycle 400.

1. The factor: L = cholesky_eri_vectors(basis, tol=cd_tol) on the card,
   cached at .cache/northstar_L_<mol>_tol<tol>.npz (key l_vec); a rerun
   loads the cache.
2. The setup: kohn_sham.prepare(..., _df_override=(L, None)) (grid and AO
   planes on the card), built once for every schedule asked for.
3. The SCF, once per --xc-impl schedule (in the order given), scf_host
   with a periodic checkpoint every 25 cycles at
   .cache/northstar_ck_<mol>_L<grid>.npz; --resume starts from that file.
4. K1 (the fused XC kernel) at the converged density on the whole grid:
   kernel and plain version ms (median of 25, CUDA events) beside its bound
   (tools/torch_kernel_timing.py).

Steps 1-3 are setup() and scf(), which chip_smoke.py's phase 4e calls too.

Prints one JSON row per schedule and writes them all to --out: molecule,
nao, ngrid, cd_tol, cd_rank, grid_level, xc_impl, converged, n_iter with
fast_cycles (kernel phase) and verify_cycles, e_tot and its difference from
the JAX package's v5e energy, the ‖ΔD‖ floor of the kernel phase, setup_s
split into Cholesky, grid, AO and the rest, scf_s, K1 launches and times,
and the card's name and power limit (nvidia-smi).  Exit 0 when every
schedule converged.  Needs a CUDA GPU; imports nothing of JAX.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the JAX package's L1 run on one v5e (docs/northstar_singlechip_L1.json and
# docs/northstar_L1_r5_run{1,2}.log): molecule, energy, grid points, factor
# rank, and the run's Cholesky tolerance and grid level
MOLECULE = "C33H56N7O17P3S"
JAX_E = -4233.490875744028
JAX_NGRID = 540054
JAX_CD_RANK = 2150
CD_TOL = 1e-5
GRID_LEVEL = 1
# where the factor and the periodic checkpoint are kept (.gitignore lists it)
CACHE = os.path.join(ROOT, ".cache")


def _factor(basis, mol_name: str, cd_tol: float, device, cache: bool,
            cache_dir: str | None = None):
    """-> (L (nao, nao, rank) on `device`, seconds to build or load it,
    whether it came from the cache).  cache: load L from cache_dir (default
    CACHE) when it is there, and save it there when it is built."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.integrals.cholesky import (
        cholesky_eri_vectors,
    )
    from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
        synced_time,
    )

    cache_dir = cache_dir or CACHE
    path = os.path.join(cache_dir,
                        f"northstar_L_{mol_name}_tol{cd_tol:g}.npz")
    t0 = synced_time(device)
    if cache and os.path.exists(path):
        l_vec = torch.as_tensor(np.load(path)["l_vec"], device=device)
        print(f"L loaded from {path}: shape {tuple(l_vec.shape)}", flush=True)
        return l_vec, synced_time(device) - t0, True
    l_vec = cholesky_eri_vectors(basis, tol=cd_tol, device=device,
                                 verbose=True)
    t_cd = synced_time(device) - t0
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp.npz"
        np.savez(tmp, l_vec=l_vec.cpu().numpy(), cd_tol=cd_tol)
        os.replace(tmp, path)
        print(f"L saved to {path}", flush=True)
    return l_vec, t_cd, False


def setup(mol_name: str = MOLECULE, cd_tol: float = CD_TOL,
          grid_level: int = GRID_LEVEL, device="cuda", cache: bool = True):
    """The factor, then kohn_sham.prepare(B3LYP, _df_override=(L, None)).
    -> (KSSetup, {"cd_rank", "cholesky_s", "cholesky_cached"})."""
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file

    device = torch.device(device)
    mol = from_xyz_file(os.path.join(ROOT, "molecules", f"{mol_name}.xyz"))
    l_vec, t_cd, cached = _factor(build_basis(mol), mol_name, cd_tol, device,
                                  cache)
    rank = int(l_vec.shape[2])
    ks = kohn_sham.prepare(mol, "B3LYP", grid_level=grid_level,
                           _df_override=(l_vec, None), device=device)
    return ks, {"cd_rank": rank, "cholesky_s": t_cd,
                "cholesky_cached": cached}


def scf(ks, xc_impl: str, max_cycle: int = 400, **kw):
    """scf_host on the setup's system for one schedule; kw passes
    callback, dm0 and checkpoint_cb/checkpoint_every through.
    -> (SCFResult, seconds, synced on the card)."""
    from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
        synced_time,
    )
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host

    dev = ks.sys.s.device
    t0 = synced_time(dev)
    # the JAX package's GGA potential (jax_potential): the run is held to
    # its recorded energy
    r = scf_host(ks.sys, ks.functional.jax_potential(), xc_impl=xc_impl,
                 max_cycle=max_cycle, **kw)
    return r, synced_time(dev) - t0


def _k1_times(ks, dm) -> dict:
    """K1 and its plain version at the converged density on the whole grid
    (median of 25 CUDA-event calls; the plain version of 5), beside its
    bound."""
    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.scf.driver import _packed_for

    s, fn, n = ks.sys, ks.functional, ks.nao
    aot, wt, grads = _packed_for(s, fn.needs_grad)
    args = (fn, dm, aot, wt, grads, n)
    ms = kt.cuda_ms(lambda: fused_xc.fused_xc(*args))
    plain = kt.cuda_ms(lambda: fused_xc.fused_xc_reference(*args), reps=5,
                       warm=1)
    bound, by, *_ = kt.xc_bound("K1", fn.needs_grad, n, s.ao.shape[0])
    return {"k1_ms": ms, "k1_plain_ms": plain, "k1_bound_ms": bound,
            "k1_bound_by": by, "npad": int(aot.shape[0])}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mol", default=MOLECULE)
    p.add_argument("--cd-tol", type=float, default=CD_TOL)
    p.add_argument("--grid-level", type=int, default=GRID_LEVEL)
    p.add_argument("--xc-impl", nargs="+", choices=("fast", "f64"),
                   default=["fast"])
    p.add_argument("--max-cycle", type=int, default=400)
    p.add_argument("--resume", action="store_true",
                   help="start from the periodic checkpoint when it exists")
    p.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                  "northstar_h100.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_northstar: needs a CUDA GPU")
    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.scf.checkpoint import (
        load_checkpoint,
        periodic_saver,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    ks, factor = setup(args.mol, args.cd_tol, args.grid_level)
    split = ks.setup_split
    print(f"nao={ks.nao} ngrid={ks.ngrid} (JAX {JAX_NGRID}) rank="
          f"{factor['cd_rank']} (JAX {JAX_CD_RANK}); Cholesky "
          f"{factor['cholesky_s']:.1f} s, prepare {ks.build_time:.1f} s "
          f"{json.dumps(split)}", flush=True)

    ck_path = os.path.join(CACHE,
                           f"northstar_ck_{args.mol}_L{args.grid_level}.npz")
    dm0 = None
    if args.resume and os.path.exists(ck_path):
        ck = load_checkpoint(ck_path)
        dm0 = ck["dm"]
        print(f"resuming from checkpoint cycle {ck['cycle']} "
              f"(E={ck['e_tot']:.8f})", flush=True)

    rows = []
    for xc_impl in args.xc_impl:
        dns = []

        def cb(cycle, eb, de, dnorm):
            dns.append(dnorm)
            print(f"{cycle + 1:3d} E={eb.e_tot:.8f} de={de:.2e} "
                  f"dn={dnorm:.2e}", flush=True)

        for k in fused_xc.LAUNCHES:
            fused_xc.LAUNCHES[k] = 0
        r, t_scf = scf(ks, xc_impl, args.max_cycle, callback=cb, dm0=dm0,
                       checkpoint_cb=periodic_saver(
                           ck_path, ks.functional.name, args.mol),
                       checkpoint_every=25)
        kernel_dns = dns[:r.fast_cycles]
        row = {
            "molecule": args.mol, "nao": ks.nao, "ngrid": ks.ngrid,
            "jax_ngrid": JAX_NGRID, "cd_tol": args.cd_tol,
            "jax_cd_rank": JAX_CD_RANK, "grid_level": args.grid_level,
            "xc_impl": xc_impl, "max_cycle": args.max_cycle,
            "resumed": dm0 is not None,
            "converged": bool(r.converged), "n_iter": r.n_iter,
            "fast_cycles": r.fast_cycles, "verify_cycles": r.verify_cycles,
            "e_tot": r.e_tot, "jax_e_tot": JAX_E, "de_jax": r.e_tot - JAX_E,
            "kernel_phase_dnorm_min": min(kernel_dns) if kernel_dns else None,
            "kernel_phase_dnorm_median_last50": (
                statistics.median(kernel_dns[-50:]) if kernel_dns else None),
            "setup_s": ks.build_time + (0.0 if factor["cholesky_cached"]
                                        else factor["cholesky_s"]),
            "grid_s": split["grid_s"], "ao_s": split["ao_s"],
            "setup_rest_s": (split["one_electron_s"] + split["two_electron_s"]
                             + split["system_s"]),
            "scf_s": t_scf, "k1_launches": fused_xc.LAUNCHES["K1"],
            "gpu": smi, **factor,
        }
        row.update(_k1_times(ks, r.dm))
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump({"runs": rows}, f, indent=1)
    return 0 if all(row["converged"] for row in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
