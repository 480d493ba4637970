"""Converge molecules end to end through the PyTorch port: the port of
tools/run_all_molecules.py, with a --golden mode that runs the rows of
tests/golden_energies.json.

    python tools/torch_run_all_molecules.py OUT.json [MOL | MOL/FN ...]
        [--golden] [--xc-impl fast|f64] [--functionals B3LYP ...]
        [--grid-level 3] [--max-atoms 60] [--device cuda|cpu]
        [--commit LABEL]

Each (molecule, functional) runs the recipe of tools/gen_golden.py:
kohn_sham.prepare at the grid level (in-core ERIs up to nao 64, density
fitting above), scf_host(xc_impl=...) with integer occupations, and when
that does not converge the FON-RKS annealing ladder
scf_host_annealed(mixer="adiis+cdiis") on the f64 host loop.  --xc-impl
fast (the default) is the main path: the fused XC kernel in the kernel
phase, f64 verify cycles and a final f64 energy; f64 is the generator's
own schedule.

Without --golden: every molecule of molecules/ with at most --max-atoms
atoms (or the ones named), for each of --functionals, at --grid-level.
With --golden: the table's rows at their grid level (all 84, or the named
molecules or MOL/FN pairs); each row adds the table's energy, the
difference, `within` (|dE| below the table's tolerance, 1e-7 Eh) and the
table's smear_kt beside the run's.  A row whose smear_kt differs from a
smeared table row is run again on the ladder with the rungs down to the
table's temperature, finish_integer=False and the damped-mixing mixer
(`recheck`, see RECHECK_MIXER): the ladder's result depends on which rungs
converge, and that rerun holds the energy at the table's temperature.

Output, rewritten after each row: with --golden {"header": {...},
"rows": {"MOL/FN": row}}; without, the sweep layout of
tools/run_all_molecules.py ({"MOL/FN": row}, as docs/results_58_r5.json,
which tools/compare_sweeps.py and tools/torch_results_md.py read) with the
header as one more key, "header".  A rerun with the same OUT skips the
rows it holds (resume).  Each row has setup_s and scf_s (host clock,
ending in a device sync), the setup cache's hits (cache_hits;
DFT_SETUP_CACHE=0 makes every setup cold), the basis provenance, the
cycles (n_iter, kernel-phase fast_cycles, verify_cycles, and the integer
attempt's when the ladder ran), and smear_kt.  --device cpu runs on the CPU, for
tests; on the card the header holds nvidia-smi's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import torch  # noqa: E402
import torch_kernel_timing as kt  # noqa: E402

from quantum_compute_dft_tpu_torch import kohn_sham  # noqa: E402
from quantum_compute_dft_tpu_torch.basis.data import provenance  # noqa: E402
from quantum_compute_dft_tpu_torch.mol import from_xyz_file  # noqa: E402
from quantum_compute_dft_tpu_torch.scf.driver import (  # noqa: E402
    ANNEAL_KTS,
    scf_host,
    scf_host_annealed,
)

GOLDEN = os.path.join(ROOT, "tests", "golden_energies.json")
PKG = os.path.join(ROOT, "quantum_compute_dft_tpu_torch")


def _sources_sha256() -> str:
    """One hash over the port's sources and this tool, so a row file names
    the code that made it where no git checkout is at hand."""
    h = hashlib.sha256()
    paths = [os.path.abspath(__file__)]
    for base, _, names in os.walk(PKG):
        paths += [os.path.join(base, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    for path in sorted(paths):
        h.update(os.path.relpath(path, ROOT).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize()


# the recheck's mixer: damped linear mixing, then CDIIS.  It extrapolates
# nothing, so the rungs it converges do not hang on rounding; ADIIS on
# CuO's kT 0.25 rung charge-sloshes for 100+ cycles and converges or not by
# the last bits of its arithmetic (the port on the CPU tracks the JAX
# package to 1e-11 Eh for 27 cycles there, then parts from it)
RECHECK_MIXER = "mix+cdiis"


def recheck(sys_, functional, kt: float):
    """The ladder's rungs down to kt, no integer finish, on RECHECK_MIXER:
    the energy at kt when the ladder proper stopped at another kT."""
    return scf_host_annealed(
        sys_, functional, kts=tuple(k for k in ANNEAL_KTS if k >= kt),
        finish_integer=False, mixer=RECHECK_MIXER)


def run_one(name: str, functional: str, grid_level: int, xc_impl: str,
            dev: torch.device, golden: dict | None = None,
            tol: float = 1e-7) -> dict:
    """One (molecule, functional) by the generator's recipe -> its row."""
    mol = from_xyz_file(os.path.join(ROOT, "molecules", name + ".xyz"))
    t0 = time.time()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        setup = kohn_sham.prepare(mol, functional, grid_level=grid_level,
                                  device=dev, cd_tol=kohn_sham.CD_TOL)
    _sync(dev)
    setup_s = time.time() - t0
    # the JAX package's GGA potential (jax_potential): the rows are compared
    # with its golden table and its sweep
    s, fn = setup.sys, setup.functional.jax_potential()

    t0 = time.time()
    r = scf_host(s, fn, xc_impl=xc_impl)
    row = {"molecule": name, "functional": functional,
           "natom": len(mol.symbols), "nao": setup.nao, "ngrid": setup.ngrid,
           "basis_provenance": sorted({provenance(x) for x in mol.symbols}),
           "cache_hits": list(setup.cache_hits),
           "density_fit": s.eri is None, "grid_level": grid_level,
           "xc_impl": xc_impl, "ladder": not r.converged}
    if not r.converged:
        row.update(first_n_iter=r.n_iter, first_fast_cycles=r.fast_cycles)
        r = scf_host_annealed(s, fn, mixer="adiis+cdiis")
        row["xc_impl"] = "f64"   # the ladder runs on the f64 host loop
    _sync(dev)
    row.update(e_tot=r.e_tot, converged=bool(r.converged), n_iter=r.n_iter,
               fast_cycles=r.fast_cycles, verify_cycles=r.verify_cycles,
               smear_kt=r.smear_kt, setup_s=setup_s,
               scf_s=time.time() - t0)
    if golden is not None:
        g_kt = golden["smear_kt"]
        row.update(e_golden=golden["e_tot"], de=r.e_tot - golden["e_tot"],
                   smear_kt_golden=g_kt, smear_match=r.smear_kt == g_kt)
        row["within"] = bool(r.converged) and abs(row["de"]) < tol
        if not row["smear_match"] and g_kt > 0.0:
            t1 = time.time()
            rr = recheck(s, fn, g_kt)
            _sync(dev)
            row["recheck"] = {
                "kts_to": g_kt, "mixer": RECHECK_MIXER, "e_tot": rr.e_tot,
                "converged": bool(rr.converged), "smear_kt": rr.smear_kt,
                "n_iter": rr.n_iter, "de": rr.e_tot - golden["e_tot"],
                "within": bool(rr.converged)
                and abs(rr.e_tot - golden["e_tot"]) < tol,
                "scf_s": time.time() - t1}
    return row


def _todo(args) -> list[tuple[str, str, int, dict | None]]:
    """(molecule, functional, grid level, golden row or None) to run."""
    if args.golden:
        with open(GOLDEN) as f:
            rows = json.load(f)["rows"]
        pick = set(args.names)
        return [(g["molecule"], g["functional"], g["grid_level"], g)
                for g in rows
                if not pick or g["molecule"] in pick
                or f"{g['molecule']}/{g['functional']}" in pick]
    names = args.names
    if not names:
        sized = []
        mdir = os.path.join(ROOT, "molecules")
        for fname in sorted(os.listdir(mdir)):
            if fname.endswith(".xyz"):
                with open(os.path.join(mdir, fname)) as fh:
                    sized.append((int(fh.readline().split()[0]), fname[:-4]))
        names = [n for natom, n in sorted(sized) if natom <= args.max_atoms]
    out = []
    for name in names:
        mol, _, only = name.partition("/")
        for fn in ([only] if only else args.functionals):
            out.append((mol, fn, args.grid_level, None))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", help="row file (JSON); resumed when it exists")
    p.add_argument("names", nargs="*",
                   help="molecules or MOL/FN pairs (default: all)")
    p.add_argument("--golden", action="store_true",
                   help="run the rows of tests/golden_energies.json")
    p.add_argument("--xc-impl", choices=("fast", "f64"), default="fast")
    p.add_argument("--functionals", nargs="+", default=["B3LYP"])
    p.add_argument("--grid-level", type=int, default=3)
    p.add_argument("--max-atoms", type=int, default=60)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--commit", default=None,
                   help="label of the code's commit, kept in the header")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    with open(GOLDEN) as f:
        tol = json.load(f)["tolerance"]
    header = dict(kt.card(args.device),
                  tool="tools/torch_run_all_molecules.py",
                  mode="golden" if args.golden else "sweep",
                  xc_impl=args.xc_impl, cuda=torch.version.cuda,
                  commit=args.commit, sources_sha256=_sources_sha256(),
                  tolerance=tol)
    results = {"header": header, "rows": {}}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        if "rows" not in results:    # the sweep layout
            old = results.pop("header")
            results = {"header": old, "rows": results}
        old = results["header"]
        if (old["mode"], old["xc_impl"]) != (header["mode"], args.xc_impl):
            raise SystemExit(f"{args.out} holds {old['mode']} rows of "
                             f"--xc-impl {old['xc_impl']}")

    for mol, fn, level, golden in _todo(args):
        key = f"{mol}/{fn}"
        if key in results["rows"] and "error" not in results["rows"][key]:
            print(f"{key}: in {args.out}, skipping", flush=True)
            continue
        t0 = time.time()
        try:
            row = run_one(mol, fn, level, args.xc_impl, dev, golden, tol)
        except Exception as exc:  # resumable: record and go on
            row = {"molecule": mol, "functional": fn, "error": repr(exc)}
        results["rows"][key] = row
        print(json.dumps({"key": key, **row}), flush=True)
        print(f"{key}: {time.time() - t0:.1f} s", flush=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(results if args.golden else
                      {"header": results["header"], **results["rows"]},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, args.out)
        # free the row's setup (ERIs, AO planes, packed planes) before
        # the next one
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    rows = list(results["rows"].values())
    summary = {"rows": len(rows),
               "converged": sum(bool(r.get("converged")) for r in rows)}
    if args.golden:
        summary.update(
            within=sum(bool(r.get("within")) for r in rows),
            smear_mismatch=sum(r.get("smear_match") is False for r in rows),
            recheck_within=sum(bool(r.get("recheck", {}).get("within"))
                               for r in rows),
            max_abs_de=max((abs(r["de"]) for r in rows if "de" in r),
                           default=None))
    print(json.dumps({"summary": summary, "out": args.out}), flush=True)
    return results


if __name__ == "__main__":
    main()
