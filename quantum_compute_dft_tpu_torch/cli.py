"""Command-line interface of the port.

``python -m quantum_compute_dft_tpu_torch {LDA,GGA,B3LYP,HF,PBE} <Molecule>``
with the console table and summary of the JAX package's CLI
(quantum_compute_dft_tpu/cli.py): banner, system info, per-cycle table
(epoch / total energy / dE / d-density / HF exchange), converged summary
with the energy decomposition, and the per-call XC kernel statistic.

``--device`` defaults to ``cuda``; without a GPU that default is an error,
and the CPU runs only when asked for with ``--device cpu``.

``--checkpoint PATH`` (the JAX CLI's): saves the density every 25 cycles
and at the end; when PATH exists and its nao, molecule and functional
match, the SCF starts from its density.

The JAX CLI's other arguments, with its semantics: ``--grid-file`` (a
6-column grid in place of the native one), ``--jit-loop`` (scf_jit: the
whole f64 SCF on the device, CUDA graphs on the card, no per-cycle table),
``--xc-impl pallas`` (every cycle on the fused f32 kernel) and
``--validate [auto|pyscf|native]`` (the end-of-run oracle: the native C++
host engine re-solves the molecule; PySCF is not available, so 'pyscf'
skips and 'auto' falls back to 'native').  Not ported: ``--staged`` (TPU
dispatch) and ``--xc-impl mixed``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from quantum_compute_dft_tpu_torch.utils.profiling import span, spanned


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quantum_compute_dft_tpu_torch",
        description="Restricted Kohn-Sham DFT (LDA/GGA/B3LYP) in PyTorch "
        "with a fused CUDA XC kernel.",
    )
    p.add_argument("functional", choices=["LDA", "GGA", "B3LYP", "HF", "PBE"],
                   help="Functional type (GGA == PBE; HF = Hartree-Fock)")
    p.add_argument("xyzfile", help="Molecule name (e.g. H2O) or path to .xyz")
    p.add_argument("--molecules-dir",
                   default=os.environ.get("DFT_MOLECULES_DIR", "./molecules"),
                   help="Directory with <name>.xyz geometries (default "
                   "./molecules)")
    p.add_argument("--grid-level", type=int, default=3,
                   help="Becke grid level 0-9")
    p.add_argument("--no-prune", action="store_true",
                   help="Disable grid pruning")
    p.add_argument("--grid-file", default=None,
                   help="6-column grid file (atom_idx x y z w w) overriding "
                   "the native grid")
    p.add_argument("--max-cycle", type=int, default=200)
    p.add_argument("--conv-tol-e", type=float, default=1e-8)
    p.add_argument("--conv-tol-d", type=float, default=1e-6)
    p.add_argument("--charge", type=int, default=0)
    p.add_argument(
        "--jit-loop", action="store_true",
        help="Run the whole f64 SCF on the device (CUDA graphs on the card; "
        "no per-cycle table)")
    p.add_argument(
        "--xc-impl", choices=["f64", "pallas", "fast"], default="fast",
        help="SCF numerics schedule: 'fast' (default: XC on the fused f32 "
        "kernel every cycle, the candidate verified by f64 cycles, final "
        "energy in f64), 'f64' (every cycle in f64) or 'pallas' (every "
        "cycle's XC on the fused f32 kernel -- on this card the fused CUDA "
        "kernel; the name is the JAX CLI's -- J/K in f64, f32 incl. the "
        "reported energy)")
    p.add_argument(
        "--density-fit", choices=["auto", "on", "off"], default="auto",
        help="J/K via the pivoted-Cholesky density-fitted ERIs (auto: on "
        "above nao 64, in-core ERIs at or below it)")
    p.add_argument(
        "--df-aux", choices=["parity", "tight", "fast"], default="parity",
        help="DF factorization: 'parity' = pivoted-Cholesky ERI vectors "
        "(guaranteed elementwise error, ~1e-6 Eh SCF parity); 'tight'/"
        "'fast' = even-tempered RI auxiliary sets (cheaper build; errors "
        "that grow with size: ~1e-5/1e-4 Eh from the Cholesky energy at "
        "DHA, nao 152)")
    p.add_argument(
        "--checkpoint", default=None,
        help="Path to save the converged density (.npz); if the file exists, "
        "resume from it")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Where to run (default cuda; the CPU only on request)")
    p.add_argument(
        "--smear-kt", type=float, default=0.0,
        help="FON-RKS Fermi smearing at this electronic temperature (Eh); "
        "0 = integer occupations.  Use for near-degenerate frontier "
        "manifolds (e.g. CuO)")
    p.add_argument(
        "--no-auto-anneal", action="store_true",
        help="Disable the automatic FON-RKS annealing-ladder retry when "
        "the integer-occupation SCF fails to converge (near-degenerate "
        "systems like CuO, where the reference crashes outright)")
    p.add_argument(
        "--validate", nargs="?", const="auto", default=None,
        choices=["auto", "pyscf", "native"],
        help="End-of-run oracle re-solve (ref dft.py:272-297): 'native' "
        "re-solves with the independently written C++ host engine "
        "(runtime/, in-core ERIs); 'pyscf' needs PySCF, which is not "
        "available, and skips; bare --validate ('auto') falls back to "
        "native")
    return p


# --validate native rebuilds a density-fitted setup in-core up to this nao
NATIVE_MAX_NAO = 130


def resolve_molecule(args) -> str:
    name = (args.xyzfile if args.xyzfile.lower().endswith(".xyz")
            else args.xyzfile + ".xyz")
    if os.path.exists(name):
        return name
    path = os.path.join(args.molecules_dir, name)
    if not os.path.exists(path):
        print(f"Error: {path} not found.")
        sys.exit(1)
    return path


def jk_label(setup) -> str:
    """How J/K were built, for the "System info" line: in-core, or the
    density-fitting factor with its rank and build seconds."""
    s = setup.sys
    if s.eri is not None:
        return "in-core ERIs"
    rank = s.df_bq.shape[0]
    if setup.df_aux in ("tight", "fast"):
        return (f"RI DF ({setup.df_aux}), naux {rank}, {setup.ri_time:.2f}s")
    if setup.df_aux == "override":
        return f"external DF factor, rank {rank}"
    if "cdvec" in setup.cache_hits:
        return f"Cholesky DF, rank {rank}, from the setup cache"
    return f"Cholesky DF, rank {rank}, {setup.df_time:.2f}s"


def _time_xc(xc_fn, device: torch.device, reps: int = 10) -> float:
    """Mean ms per call: CUDA events on the card, host clock on the CPU."""
    xc_fn()  # warm-up
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            xc_fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        xc_fn()
    return (time.perf_counter() - t0) / reps * 1000.0


@spanned("job")
def run(argv=None, *, half_sigma: bool = False,
        cd_tol: float | None = None):
    """Parse, prepare, run the SCF and print the report.  -> (setup,
    SCFResult, scf_seconds).  The whole job is the span "job"
    (utils/profiling.py), the XC statistic "job.xc_statistic".

    half_sigma and cd_tol (keywords of this call, not options of the
    command), for comparisons with the JAX package's PBE and B3LYP numbers:
    half_sigma runs the job on the functional's jax_potential() copy, so
    every V_xc it forms is the JAX package's, half the sigma term of
    dE_xc/dD; cd_tol is the Cholesky's threshold in place of the
    functional's (kohn_sham.CD_TOL, the JAX package's)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda (the default) needs a CUDA GPU; pass "
                     "--device cpu to run on the CPU")
    device = torch.device(args.device)
    atom_path = resolve_molecule(args)
    mol_name = os.path.basename(atom_path)

    print(f"=== DFT (PyTorch, {device.type}) | functional: {args.functional}"
          f" | molecule: {mol_name} ===")
    print("Building host data (basis, integrals, grid)...")

    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.engine.fused_xc import xc_step_fused
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
    from quantum_compute_dft_tpu_torch.grids import load_grid_file
    from quantum_compute_dft_tpu_torch.mol import from_xyz_file
    from quantum_compute_dft_tpu_torch.scf.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from quantum_compute_dft_tpu_torch.scf.driver import SCFResult, scf_jit
    from quantum_compute_dft_tpu_torch.xc.functionals import FUNCTIONALS

    mol = from_xyz_file(atom_path, charge=args.charge)
    grid = load_grid_file(args.grid_file) if args.grid_file else None
    density_fit = {"auto": None, "on": True, "off": False}[args.density_fit]
    functional = FUNCTIONALS[args.functional]
    if half_sigma:
        functional = functional.jax_potential()
    setup = kohn_sham.prepare(mol, functional,
                              grid_level=args.grid_level, grid=grid,
                              prune=not args.no_prune,
                              density_fit=density_fit, df_aux=args.df_aux,
                              device=device, cd_tol=cd_tol)
    print(f"System info: NAO={setup.nao}  grid points={setup.ngrid}  "
          f"occupied={setup.nocc}  J/K: {jk_label(setup)}  (build "
          f"{setup.build_time:.2f}s)")

    dm0 = None
    if args.checkpoint and os.path.exists(args.checkpoint):
        ck = load_checkpoint(args.checkpoint)
        # the stored metadata must match, not just nao: a checkpoint from a
        # different molecule/functional with the same nao is a wrong guess
        if ck["dm"].shape[0] != setup.nao:
            print(f"Checkpoint {args.checkpoint} has nao={ck['dm'].shape[0]} "
                  f"!= {setup.nao}; starting from the initial guess.")
        elif ck["molecule"] and ck["molecule"] != mol_name:
            print(f"Checkpoint {args.checkpoint} is for molecule "
                  f"{ck['molecule']!r}, not {mol_name!r}; skipping resume.")
        elif ck["functional"] and ck["functional"] != setup.functional.name:
            print(f"Checkpoint {args.checkpoint} is for functional "
                  f"{ck['functional']}, not {setup.functional.name}; "
                  "skipping resume.")
        else:
            dm0 = ck["dm"]
            print(f"Resuming from checkpoint {args.checkpoint} "
                  f"(cycle {ck['cycle']}, E={ck['e_tot']:.8f})")

    t_start = time.time()
    if args.jit_loop:
        # the JAX CLI's --jit-loop: scf_jit from the initial guess with the
        # module's convergence constants, no table, no ladder
        dm, eb, n_iter, done = scf_jit(setup.sys, setup.functional,
                                       max_cycle=args.max_cycle)
        res = SCFResult(done, n_iter, dm, eb, eb.e_tot)
    else:
        res = _scf(args, setup, mol_name, dm0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    total_time = time.time() - t_start
    if args.checkpoint:
        save_checkpoint(args.checkpoint, res.dm, res.e_tot, res.n_iter,
                        setup.functional.name, mol_name)

    # standalone XC statistic of the engine that ran the SCF's cycles
    s = setup.sys
    if args.xc_impl in ("fast", "pallas") and not args.jit_loop:
        xc_label = "fused f32 CUDA" if device.type == "cuda" else \
            "fused f32 plain (cpu)"
        xc_fn = lambda: xc_step_fused(  # noqa: E731
            setup.functional, res.dm, s.ao, s.weights, s.ao_grad)
    else:
        xc_label = "f64"
        xc_fn = lambda: xc_step(  # noqa: E731
            setup.functional, res.dm, s.ao, s.weights, s.ao_grad)
    with span("job.xc_statistic"):
        xc_ms = _time_xc(xc_fn, device)

    eb = res.energy
    print("-" * 80)
    if res.converged:
        print(f"Converged in {res.n_iter} cycles")
    else:
        print("SCF did not converge")
    if res.smear_kt > 0.0:
        print(f"FON smearing : kT = {res.smear_kt:g} Eh")
    print(f"Total energy : {res.e_tot:.8f} Ha")
    print(f"  E_one      : {eb.e_one:.8f} Ha")
    print(f"  E_coul     : {eb.e_coul:.8f} Ha")
    print(f"  E_nuc      : {s.e_nuc:.8f} Ha")
    print(f"  E_xc       : {eb.e_xc:.8f} Ha")
    if setup.functional.hyb_coeff:
        print(f"  E_ex_hf    : {eb.e_ex_hf:.8f} Ha")
    print(f"SCF time     : {total_time:.4f} s")
    print("-" * 80)
    print("Kernel statistics (avg per call):")
    print(f"  XC(Exc+Vxc): {xc_ms:.4f} ms  [{xc_label} engine]")
    print("-" * 80)
    if args.validate:
        _validate(args.validate, mol, setup, res.e_tot, args.grid_level,
                  device)
    return setup, res, total_time


def _scf(args, setup, mol_name, dm0):
    """The host SCF loop with the per-cycle table, and the annealing-ladder
    retry when the integer-occupation run fails."""
    from quantum_compute_dft_tpu_torch.scf.checkpoint import periodic_saver
    from quantum_compute_dft_tpu_torch.scf.driver import (
        scf_host,
        scf_host_annealed,
    )

    print("\nSCF started")
    print("-" * 80)
    print(f"{'epoch':>5} {'total energy':>18} {'dE':>14} {'d-density':>14} "
          f"{'HF_Ex':>12}")
    print("-" * 80)

    def cb(cycle, eb, de, dnorm):
        print(f"{cycle + 1:5d} {eb.e_tot:18.8f} {de:14.6e} {dnorm:14.6e} "
              f"{eb.e_ex_hf:12.6f}")

    kwargs = dict(callback=cb, max_cycle=args.max_cycle,
                  conv_tol_e=args.conv_tol_e, conv_tol_d=args.conv_tol_d,
                  dm0=dm0)
    # mid-run periodic saves (atomic): a crash deep into a long run resumes
    # from the last save instead of the initial guess
    ck_cb = (periodic_saver(args.checkpoint, setup.functional.name, mol_name)
             if args.checkpoint else None)
    res = scf_host(setup.sys, setup.functional, xc_impl=args.xc_impl,
                   smear_kt=args.smear_kt, checkpoint_cb=ck_cb, **kwargs)
    if (not res.converged and args.smear_kt == 0.0
            and not args.no_auto_anneal):
        # integer occupations have no reachable fixed point for some
        # near-degenerate systems (the CuO d-shell doublet); retry with the
        # FON-RKS ladder on the f64 host loop with the ADIIS->CDIIS mixer,
        # as the JAX package's CLI does
        print("-" * 80)
        print("SCF did not converge with integer occupations; "
              "retrying with the FON-RKS annealing ladder "
              "(Fermi smearing, kT 0.5 annealed toward 0.1; the "
              "coldest converged rung is reported)")
        res = scf_host_annealed(setup.sys, setup.functional,
                                mixer="adiis+cdiis", **kwargs)
    return res


def _validate(mode, mol, setup, e_tot, grid_level, device):
    """End-of-run oracle (ref dft.py:272-297): the native C++ host engine
    re-solves the molecule and the energy difference is printed.  PySCF is
    not available to the port, so 'pyscf' skips and 'auto' falls back to
    'native'."""
    if mode == "pyscf":
        print("PySCF not available in this environment; skipping "
              "validation.")
        return
    if mode == "auto":
        print("PySCF not available; validating with the native C++ engine "
              "instead (--validate native).")
    _validate_native(mol, setup, e_tot, grid_level, device)


def _validate_native(mol, setup, e_tot, grid_level, device):
    """Re-solve with the independently written C++ host engine
    (runtime/native_scf.py: C-ABI XC/J, scipy eigh and numpy CDIIS, the
    reference driver's shape, ref dft.py:199-266) on the setup's in-core
    operands moved to host numpy, and print the energy difference.  It runs
    on the host by design: an engine apart from the SCF it checks.  A
    density-fitted setup is rebuilt in-core (on `device`) up to nao 130."""
    functional = setup.functional.name
    if functional not in ("LDA", "GGA", "B3LYP"):
        print(f"native validation supports LDA/GGA/B3LYP only "
              f"(got {functional}); skipping.")
        return
    from quantum_compute_dft_tpu_torch.runtime import (
        build_library,
        run_native_scf,
    )

    try:
        build_library()
    except (OSError, RuntimeError) as e:  # no g++ toolchain, build failure
        print(f"native engine unavailable ({type(e).__name__}: {e}); "
              "skipping validation.")
        return
    s = setup.sys
    if s.eri is None:
        # the density-fitted setup has no in-core ERIs, which the C engine
        # needs; rebuild in-core when the (nao^4) tensor is small enough
        if setup.nao > NATIVE_MAX_NAO:
            print(f"native validation needs the in-core ERI path "
                  f"(nao={setup.nao} > {NATIVE_MAX_NAO}); skipping.")
            return
        from quantum_compute_dft_tpu_torch import kohn_sham

        s = kohn_sham.prepare(mol, functional, grid_level=grid_level,
                              density_fit=False, device=device).sys

    def host(a):
        return None if a is None else a.cpu().numpy()

    t0 = time.time()
    e_nat, _dm, n_iter, conv = run_native_scf(
        functional, host(s.hcore), host(s.s), host(s.eri), host(s.ao),
        host(s.weights), host(s.ao_grad), s.e_nuc, s.nocc,
        sigma_factor=setup.functional.sigma_factor)
    tag = "" if conv else " (UNCONVERGED)"
    print(f"native C++ ({functional}) energy : {e_nat:.10f} Ha"
          f"  [{n_iter} cycles{tag}]")
    print(f"difference                : {abs(e_nat - e_tot):.2e} Ha")
    print(f"native engine time        : {time.time() - t0:.4f} s")


def main(argv=None) -> int:
    _, res, _ = run(argv)
    return 0 if res.converged else 2


if __name__ == "__main__":
    sys.exit(main())
