"""The sharded SCF over a rank group (one process per GPU) through the
PyTorch port, on the north star by default.

    python tools/torch_northstar_mesh.py [--mode parity converge builders]
        [--ranks N] [--cycles 5] [--max-cycle 200] [--reference]
        [--mol C33H56N7O17P3S] [--cd-tol 1e-5] [--grid-level 1]
        [--out docs/northstar_mesh_h100.json]

The port of tools/northstar_mesh_parity.py, tools/converge_northstar.py and
tools/dryrun_northstar.py in one tool (--max-cycle 1 is the dryrun).  The
ranks run parallel/sharded_scf.make_sharded_scf (grid-sharded f64 XC,
aux-sharded Cholesky J/K, one sum per build, CDIIS and eigh replicated):

  parity    --cycles cycles of the sharded step beside scf_iteration on the
            whole system on rank 0's card, from the same SAD density, the
            two trajectories apart: per cycle |dE| <= 1e-8 and max|dD| <=
            1e-7 (the JAX tool's rule);
  converge  the sharded loop from the SAD density to |dE| < 1e-8 and
            ||dD||_F < 1e-6 (the reference's rule; config's d_tol) within
            --max-cycle cycles; --reference then runs scf_host(xc_impl=
            "f64") with the same rule on rank 0's whole system, the one-card
            loop of the same setup;
  builders  the sharded XC and J/K at a seeded perturbed SAD density against
            xc_step and the single-device J/K on rank 0 (in-core ERIs when
            --cd-tol is 0).

The factor (pivoted Cholesky at --cd-tol) is built once, by rank 0, with
tools/torch_northstar.py's _factor into .cache/ (config's factor_dir; a
rerun loads it); the other ranks load that file after a barrier.  Each
rank then runs kohn_sham.prepare(..., _df_override=(L, None)) on its own
card, cuts its shard of the planes and the factor, and frees the rest
(rank 0 keeps the whole system when parity or --reference needs it).
After the last step every rank's density is held to rank 0's bit for bit
(parallel.mesh.replica_spread).

Writes one JSON record to --out: per-cycle rows, ranks, nao, ngrid,
cd_rank, the setup split, converged, cycles, e_tot and its difference from
the JAX package's energy (the north star's only), the replica spread, K1/K2
launches per rank, and the card's name and power limit.  Exit 0 when every
mode met its bar.  The CLI puts rank r on card r (NCCL); run(cfg, world,
"gloo", "cuda:0") puts every rank on card 0, run(cfg, world, "gloo",
"cpu") on the CPU (the tests).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
sys.path[:0] = [ROOT, TOOLS]

import torch_northstar as ns  # noqa: E402

from quantum_compute_dft_tpu_torch.integrals.density_fitting import (  # noqa: E402
    synced_time,
)

PARITY_E, PARITY_D = 1e-8, 1e-7     # the JAX parity tool's per-cycle rule
E_TOL, D_TOL = 1e-8, 1e-6           # the reference's convergence rule
MAX_CYCLES = 200
NORTHSTAR_TOL = 1e-6                # against ns.JAX_E
BUILDERS_TOL = 1e-11                # tests/test_parallel.py's bar
# the loops' energies are held to the JAX package's records (the north
# star's, chip_smoke.py's DHA), so the sharded step, scf_iteration and
# scf_host all run on the functional's jax_potential() copy: its GGA
# potential, half the sigma term of dE_xc/dD


def _setup(shard, cfg):
    """Rank 0 builds (or loads) the factor, the others load it after a
    barrier; then this rank's prepare -> (KSSetup, split dict)."""
    import torch

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.basis import build_basis
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.parallel.mesh import all_reduce_sum

    dev = shard.device
    mol = from_xyz_file(os.path.join(ROOT, "molecules", cfg["mol"] + ".xyz"))
    split = {}
    override = None
    if cfg["cd_tol"]:
        basis = build_basis(mol)
        if shard.rank == 0:
            l_vec, split["factor_s"], split["factor_cached"] = ns._factor(
                basis, cfg["mol"], cfg["cd_tol"], dev, True, cfg["factor_dir"])
        all_reduce_sum(shard, torch.zeros(1, device=dev))   # the barrier
        if shard.rank != 0:
            l_vec, split["factor_s"], split["factor_cached"] = ns._factor(
                basis, cfg["mol"], cfg["cd_tol"], dev, True, cfg["factor_dir"])
        override = (l_vec, None)
        del l_vec
    t0 = synced_time(dev)
    ks = kohn_sham.prepare(mol, "B3LYP", grid_level=cfg["grid_level"],
                           density_fit=bool(cfg["cd_tol"]),
                           _df_override=override, device=dev)
    split["prepare_s"] = synced_time(dev) - t0
    split.update(ks.setup_split)
    return ks, split


def _builders(shard, ks, rec):
    """Sharded XC and J/K at a seeded perturbed SAD density against the
    single-device functions (rank 0)."""
    import numpy as np
    import torch

    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
    from quantum_compute_dft_tpu_torch.parallel import (
        shard_grid_arrays,
        sharded_df_builders,
        sharded_fock_builders,
        sharded_xc_step,
    )
    from quantum_compute_dft_tpu_torch.parallel.mesh import (
        local_block,
        replica_spread,
    )
    from quantum_compute_dft_tpu_torch.scf.driver import (
        _build_j,
        _build_k,
        initial_guess,
    )

    s, fn, dev = ks.sys, ks.functional, shard.device
    pert = np.random.default_rng(3).standard_normal((ks.nao, ks.nao)) * 1e-2
    dm = initial_guess(s) + torch.as_tensor(pert + pert.T, device=dev)
    t0 = synced_time(dev)
    ao, w, g = shard_grid_arrays(shard, s.ao, s.weights, s.ao_grad)
    e, v = sharded_xc_step(shard, fn)(dm, ao, w, g)
    if s.eri is not None:
        eri_loc = local_block(shard, s.eri, 0)
        j_fn, k_fn = sharded_fock_builders(shard)
        j, k = j_fn(eri_loc, dm), k_fn(eri_loc, dm)
    else:
        j, k = sharded_df_builders(shard, s.df_bq.permute(1, 2, 0), None)(dm)
    rec["builders_s"] = synced_time(dev) - t0
    rec["builders_spread"] = max(replica_spread(shard, t)
                                 for t in (e.reshape(1), v, j, k))
    if shard.rank == 0:
        e1, v1 = xc_step(fn, dm, s.ao, s.weights, s.ao_grad)
        rec["builders"] = {
            "dE_xc": float(e - e1), "max_dV": float((v - v1).abs().max()),
            "max_dJ": float((j - _build_j(s, dm)).abs().max()),
            "max_dK": float((k - _build_k(s, dm)).abs().max())}


def _loop(step, dm, diis, max_cycle, d_tol, dev, rows):
    """The sharded loop to |dE| < E_TOL and ||dD|| < d_tol; appends one row
    per cycle -> (dm, e_tot, cycles, converged)."""
    import torch

    e_old = 0.0
    for cycle in range(1, max_cycle + 1):
        t0 = synced_time(dev)
        dm_new, diis, e = step(dm, diis)
        e = float(e)
        dn = float(torch.linalg.norm(dm_new - dm))
        rows.append({"cycle": cycle, "e_tot": e, "dE": e - e_old, "dD": dn,
                     "s": synced_time(dev) - t0})
        converged = abs(e - e_old) < E_TOL and dn < d_tol
        dm, e_old = dm_new, e
        if converged:
            return dm, e, cycle, True
    return dm, e_old, max_cycle, False


def mesh_run(shard, cfg) -> dict:
    """One rank of the tool (see the module docstring) -> its record: rank
    0's holds every number; the others' their spread, setup and launches."""
    import torch

    from quantum_compute_dft_tpu_torch.engine import fused_xc
    from quantum_compute_dft_tpu_torch.parallel.mesh import replica_spread
    from quantum_compute_dft_tpu_torch.parallel.sharded_scf import (
        make_sharded_scf,
    )
    from quantum_compute_dft_tpu_torch.scf.diis import diis_init
    from quantum_compute_dft_tpu_torch.scf.driver import scf_host, scf_iteration

    for k in fused_xc.LAUNCHES:
        fused_xc.LAUNCHES[k] = 0
    dev = shard.device
    modes = cfg["modes"]
    ks, split = _setup(shard, cfg)
    fn = ks.functional.jax_potential()
    rec = {"rank": shard.rank, "setup": split}
    if "builders" in modes:
        _builders(shard, ks, rec)
    t0 = synced_time(dev)
    step, dm0, diis0 = make_sharded_scf(shard, ks.sys, fn)
    split["shard_s"] = synced_time(dev) - t0
    if shard.rank == 0:
        rec.update(nao=ks.nao, ngrid=ks.ngrid,
                   cd_rank=None if ks.sys.eri is not None
                   else int(ks.sys.df_bq.shape[0]))
    keep = shard.rank == 0 and ("parity" in modes or cfg["reference"])
    if not keep:
        del ks
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    spreads = []
    if "parity" in modes:
        rows = rec["parity_rows"] = []
        dm, diis = dm0, diis0
        dm_s, diis_s = dm0.clone(), diis_init(dm0.shape[0], device=dev)
        for cycle in range(1, cfg["cycles"] + 1):
            t0 = synced_time(dev)
            dm, diis, e = step(dm, diis)
            e = float(e)
            row = {"cycle": cycle, "e_mesh": e, "s_mesh": synced_time(dev) - t0}
            if shard.rank == 0:
                t0 = synced_time(dev)
                dm_s, diis_s, en, _ = scf_iteration(ks.sys, fn, dm_s, diis_s)
                row.update(e_single=float(en[0]),
                           s_single=synced_time(dev) - t0,
                           dE=e - float(en[0]),
                           max_dD=float((dm - dm_s).abs().max()))
            rows.append(row)
        spreads.append(replica_spread(shard, dm))
        if shard.rank == 0:
            rec["parity_ok"] = all(abs(r["dE"]) <= PARITY_E
                                   and r["max_dD"] <= PARITY_D for r in rows)
    if "converge" in modes:
        rows = rec["converge_rows"] = []
        dm, e, cycles, conv = _loop(step, dm0.clone(),
                                    diis_init(dm0.shape[0], device=dev),
                                    cfg["max_cycle"], cfg["d_tol"], dev, rows)
        spreads.append(replica_spread(shard, dm))
        rec.update(converged=conv, cycles=cycles, e_tot=e,
                   scf_s=sum(r["s"] for r in rows),
                   cycle_s_median=statistics.median(r["s"] for r in rows))
        if shard.rank == 0 and cfg["reference"]:
            t0 = synced_time(dev)
            r = scf_host(ks.sys, fn, xc_impl="f64", conv_tol_d=cfg["d_tol"])
            rec["reference"] = {"converged": r.converged, "cycles": r.n_iter,
                                "e_tot": r.e_tot, "s": synced_time(dev) - t0,
                                "dE_mesh": e - r.e_tot}
    rec["spread"] = max(spreads, default=0.0)
    rec["launches"] = dict(fused_xc.LAUNCHES)
    return rec


def run(cfg: dict, ranks: int, backend: str, device: str) -> dict:
    """mesh_run on `ranks` processes -> rank 0's record, with every rank's
    spread, setup split and launches beside it."""
    from quantum_compute_dft_tpu_torch.parallel.launch import run_ranks

    recs = run_ranks(mesh_run, ranks, backend, device, cfg)
    out = dict(recs[0], ranks=ranks, backend=backend, device=device,
               config=cfg)
    out["spread"] = max(r["spread"] for r in recs)
    if "builders_spread" in out:
        out["builders_spread"] = max(r["builders_spread"] for r in recs)
    out["setup_by_rank"] = [r["setup"] for r in recs]
    out["launches_by_rank"] = [r["launches"] for r in recs]
    if cfg["mol"] == ns.MOLECULE and "e_tot" in out:
        out.update(jax_e_tot=ns.JAX_E, de_jax=out["e_tot"] - ns.JAX_E)
    return out


def config(mol=ns.MOLECULE, grid_level=ns.GRID_LEVEL, cd_tol=ns.CD_TOL,
           modes=("parity", "converge"), cycles=5, max_cycle=MAX_CYCLES,
           d_tol=D_TOL, reference=False, factor_dir=None) -> dict:
    """The record run() takes: B3LYP on molecules/<mol>.xyz (cd_tol 0:
    in-core ERIs)."""
    return {"mol": mol, "grid_level": grid_level,
            "cd_tol": cd_tol, "modes": list(modes), "cycles": cycles,
            "max_cycle": max_cycle, "d_tol": d_tol, "reference": reference,
            "factor_dir": factor_dir or ns.CACHE}


def failures(out: dict) -> list:
    """The bars `out` misses (empty when every mode met its bar)."""
    cfg, bad = out["config"], []
    if out["spread"] != 0.0:
        bad.append(f"the ranks' densities differ by {out['spread']}")
    if "parity" in cfg["modes"] and not out["parity_ok"]:
        bad.append("parity outside |dE| <= 1e-8, max|dD| <= 1e-7")
    if "converge" in cfg["modes"]:
        if not out["converged"] and cfg["max_cycle"] > 1:
            bad.append("the sharded loop did not converge")
        if "de_jax" in out and abs(out["de_jax"]) >= NORTHSTAR_TOL:
            bad.append(f"E {out['e_tot']} vs the JAX package's {ns.JAX_E}")
    if "builders" in cfg["modes"]:
        worst = max(abs(v) for v in out["builders"].values())
        if worst >= BUILDERS_TOL or out["builders_spread"] != 0.0:
            bad.append(f"builders {out['builders']}")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--mode", nargs="+", default=["parity"],
                   choices=("parity", "converge", "builders"))
    p.add_argument("--ranks", type=int, default=None,
                   help="default: torch.cuda.device_count()")
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--max-cycle", type=int, default=MAX_CYCLES)
    p.add_argument("--reference", action="store_true")
    p.add_argument("--mol", default=ns.MOLECULE)
    p.add_argument("--cd-tol", type=float, default=ns.CD_TOL)
    p.add_argument("--grid-level", type=int, default=ns.GRID_LEVEL)
    p.add_argument("--out", default=os.path.join(ROOT, "docs",
                                                  "northstar_mesh_h100.json"))
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_northstar_mesh: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print("\n".join(smi), flush=True)
    cfg = config(args.mol, args.grid_level, args.cd_tol, args.mode,
                 args.cycles, args.max_cycle, reference=args.reference)
    ranks = args.ranks or torch.cuda.device_count()
    t0 = time.time()
    out = run(cfg, ranks, "nccl", "cuda")
    out.update(total_s=time.time() - t0, gpu=smi)
    bad = failures(out)
    out["ok"] = not bad
    print(json.dumps(out), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    for b in bad:
        print(f"torch_northstar_mesh: {b}", file=sys.stderr)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
