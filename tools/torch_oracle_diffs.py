"""The port's SCF against the independent C++ engine: the cross-validation
matrix of tools/oracle_diffs.py, through the PyTorch port.

    python tools/torch_oracle_diffs.py [OUT.md] [--device cuda|cpu]

The C++ engine (runtime/dft_host.cpp, dual-number forward-AD functionals,
driven by runtime/native_scf.run_native_scf: scipy eigh and numpy CDIIS
on the host) is the offline stand-in for the reference's PySCF oracle
pass.  Each SCF row reports |E_stat(native dm) - E_stat(port dm)|, both
stationary energies (scf.driver.energy_of_dm) at the shared in-core
Hamiltonian at grid level 1, for both schedules of the port's scf_host
(fast: the fused XC kernel K1/K2 in the kernel phase, then f64 verify
cycles; f64).  The DF rows run the port on its Cholesky density
fitting and the native engine in-core.  Bars: 1e-7 Eh in-core, 1e-6 Eh
DF (tests/test_runtime.py).

Fixed-density rows (SAD density, grid 1): CuO (odd-electron doublet: no
integer-occupation fixed point) E_xc, V_xc and J of the port's f64 engine
against the C++ engine, LDA/GGA/B3LYP; DHA (nao 152) B3LYP E_xc and V_xc
on full planes through the f64 engine (bars 1e-8 Eh and 1e-8) and
through the fused XC kernel K1 (engine/fused_xc.py; on the CPU its plain
version), each against the C++ engine on the same planes, K1 within its
contract against f64 (relative dE_xc 5e-5, max dV 5e-5).

Writes OUT.md (default docs/oracle_diffs_h100.md) with the device (on the
card nvidia-smi's name and power limit) and each row's seconds; exits 1
when a row misses its bar.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tools")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quantum_compute_dft_tpu_torch import kohn_sham  # noqa: E402
from quantum_compute_dft_tpu_torch.mol import from_xyz_file  # noqa: E402

ROWS = [
    # (molecule, functional, density fitting on the port's side, class)
    ("H2O", "LDA", False, "light, in-core"),
    ("H2O", "GGA", False, "light, in-core"),
    ("H2O", "B3LYP", False, "light, in-core"),
    ("SeO3", "LDA", False, "d-shell (Se 3d), in-core"),
    ("SeO3", "B3LYP", False, "d-shell (Se 3d), in-core + hybrid K"),
    ("HBr", "GGA", False, "d-shell (Br 3d), in-core"),
    ("H2Se", "B3LYP", False, "d-shell (Se 3d), in-core + hybrid K"),
    ("Benzene", "B3LYP", True, "light, port side Cholesky DF"),
    ("H2SeO4", "B3LYP", True, "d-shell (Se 3d), port side Cholesky DF"),
]
XC_IMPLS = ("fast", "f64")
TOL_INCORE = 1e-7
TOL_DF = 1e-6
# fixed density, f64 engine vs the C++ engine (tests/test_runtime.py):
# E_xc, V_xc, J at H2O size; E_xc and V_xc at DHA
TOL_FIXED = 1e-10, 1e-9, 1e-12
TOL_DHA = 1e-8, 1e-8
# the fused kernel's contract against f64 (tests/test_pallas.py)
TOL_K1 = 5e-5, 5e-5


def _host(a):
    return None if a is None else np.ascontiguousarray(a.detach().cpu().numpy())


def _prepare(name, functional, dev, **kw):
    mol = from_xyz_file(os.path.join(ROOT, "molecules", name + ".xyz"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return kohn_sham.prepare(mol, functional, grid_level=1, device=dev,
                                 **kw)


def scf_row(name: str, functional: str, density_fit: bool, xc_impl: str,
            dev) -> dict:
    """One SCF row: the port's scf_host against run_native_scf."""
    from quantum_compute_dft_tpu_torch.runtime import run_native_scf
    from quantum_compute_dft_tpu_torch.scf.driver import energy_of_dm, scf_host

    t0 = time.time()
    setup = _prepare(name, functional, dev, density_fit=density_fit)
    ic = (_prepare(name, functional, dev, density_fit=False)
          if density_fit else setup)
    res = scf_host(setup.sys, setup.functional, xc_impl=xc_impl)
    s = ic.sys
    e_nat, dm_nat, n_nat, conv = run_native_scf(
        functional, _host(s.hcore), _host(s.s), _host(s.eri), _host(s.ao),
        _host(s.weights), _host(s.ao_grad), s.e_nuc, s.nocc)
    e_nat_stat = energy_of_dm(s, ic.functional,
                              torch.as_tensor(dm_nat, device=dev)).e_tot
    e_port_stat = energy_of_dm(s, ic.functional, res.dm).e_tot
    de = abs(e_nat_stat - e_port_stat)
    tol = TOL_DF if density_fit else TOL_INCORE
    return {"molecule": name, "functional": functional,
            "density_fit": density_fit, "xc_impl": xc_impl, "nao": ic.nao,
            "ngrid": ic.ngrid, "de": de, "tol": tol,
            "converged": bool(res.converged and conv),
            "cycles": res.n_iter, "fast_cycles": res.fast_cycles,
            "native_cycles": n_nat, "e_tot": res.e_tot,
            "within": bool(res.converged and conv and de < tol),
            "seconds": time.time() - t0}


def cuo_rows(dev) -> list[dict]:
    """CuO at its SAD density: E_xc, V_xc (f64 engine) and J."""
    from quantum_compute_dft_tpu_torch.engine.coulomb import coulomb_full
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
    from quantum_compute_dft_tpu_torch.runtime import HostSolverWrapper
    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess

    rows = []
    for fn in ("LDA", "GGA", "B3LYP"):
        t0 = time.time()
        setup = _prepare("CuO", fn, dev, density_fit=False)
        s = setup.sys
        dm = initial_guess(s)
        e_ref, v_ref = xc_step(setup.functional, dm, s.ao, s.weights,
                               s.ao_grad)
        w = HostSolverWrapper(fn)
        dmh = _host(dm)
        vxc = np.zeros_like(dmh)
        exc = w.compute_xc(dmh, _host(s.ao), _host(s.weights), vxc,
                           _host(s.ao_grad))
        n = dmh.shape[0]
        j = np.zeros((n, n))
        w.compute_coulomb(np.ascontiguousarray(
            _host(s.eri).reshape(n * n, n * n)), dmh, j)
        de = abs(exc - float(e_ref))
        dv = float(np.abs(vxc - _host(v_ref)).max())
        dj = float(np.abs(j - _host(coulomb_full(s.eri, dm))).max())
        rows.append({"molecule": "CuO", "functional": fn, "nao": setup.nao,
                     "ngrid": setup.ngrid, "de_xc": de, "dv_xc": dv,
                     "dj": dj, "within": bool(de < TOL_FIXED[0]
                                              and dv < TOL_FIXED[1]
                                              and dj < TOL_FIXED[2]),
                     "seconds": time.time() - t0})
    return rows


def dha_rows(dev, engines=("f64", "K1")) -> list[dict]:
    """DHA B3LYP at its SAD density on full grid-1 planes: the f64 engine
    and K1 each against the C++ engine on the same planes (the factor is
    the cheap RI 'fast' tier: J/K play no part)."""
    from quantum_compute_dft_tpu_torch.engine.fused_xc import xc_step_fused
    from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
    from quantum_compute_dft_tpu_torch.runtime import HostSolverWrapper
    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess

    t0 = time.time()
    setup = _prepare("DHA", "B3LYP", dev, density_fit=True, df_aux="fast")
    s, fn = setup.sys, setup.functional
    dm = initial_guess(s)
    dmh = _host(dm)
    vxc = np.zeros_like(dmh)
    t1 = time.time()
    exc = HostSolverWrapper("B3LYP").compute_xc(
        dmh, _host(s.ao), _host(s.weights), vxc, _host(s.ao_grad))
    native_s = time.time() - t1
    e64, v64 = xc_step(fn, dm, s.ao, s.weights, s.ao_grad)
    e64 = float(e64)
    rows = []
    for eng in engines:
        if eng == "f64":
            e, v = e64, v64
        else:
            e, v = xc_step_fused(fn, dm, s.ao, s.weights, s.ao_grad)
            e = float(e)
        de = abs(e - exc)
        dv = float(np.abs(vxc - _host(v)).max())
        row = {"molecule": "DHA", "functional": "B3LYP", "engine": eng,
               "nao": setup.nao, "ngrid": setup.ngrid, "de_xc": de,
               "dv_xc": dv, "native_s": native_s}
        if eng == "f64":
            row["within"] = bool(de < TOL_DHA[0] and dv < TOL_DHA[1])
        else:
            row["rel_de_xc"] = de / abs(exc)
            row["rel_de_vs_f64"] = abs(e - e64) / abs(e64)
            row["dv_vs_f64"] = float(torch.abs(v - v64).max())
            row["within"] = bool(row["rel_de_xc"] < TOL_K1[0]
                                 and dv < TOL_K1[1]
                                 and row["rel_de_vs_f64"] < TOL_K1[0]
                                 and row["dv_vs_f64"] < TOL_K1[1])
        rows.append(row)
    rows[-1]["seconds"] = time.time() - t0
    return rows


def _md(head, scf, cuo, dha) -> str:
    where = (f"{head['gpu']}, {head['power_limit']} power limit"
             if head["gpu"] else "the CPU")
    lines = [
        "# The port's SCF against the independent C++ engine",
        "",
        "`tools/torch_oracle_diffs.py --device "
        f"{head['device']}` on {where} (torch {head['torch']}).",
        "The port's `scf_host` and the C++ engine (`runtime/dft_host.cpp`",
        "through `run_native_scf`) each converge an SCF; each row is",
        "|E_stat(native dm) - E_stat(port dm)|, both stationary energies",
        "(`energy_of_dm`) at the shared in-core Hamiltonian, grid level 1.",
        f"Bars: {TOL_INCORE:g} Eh in-core, {TOL_DF:g} Eh DF. Schedules: "
        + ", ".join(f"`{x}`" for x in XC_IMPLS) + " (`fast`: K1/K2 in the",
        "kernel phase, then f64 verify cycles).",
        "",
        "| Molecule | Functional | Path class | xc_impl | nao | dE (Eh) | "
        "bar | cycles (kernel) | native cycles | s |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    klass = {(m, f): c for m, f, _, c in ROWS}
    for r in scf:
        lines.append(
            f"| {r['molecule']} | {r['functional']} | "
            f"{klass[(r['molecule'], r['functional'])]} | {r['xc_impl']} | "
            f"{r['nao']} | {r['de']:.2e} | {r['tol']:g}"
            f"{'' if r['within'] else ' MISSED'} | {r['cycles']} "
            f"({r['fast_cycles']}) | {r['native_cycles']} | "
            f"{r['seconds']:.2f} |")
    if cuo:
        lines += [
            "", "CuO (Cu 3d, odd-electron doublet: integer-occupation SCF "
            "has no fixed point) at its SAD density, the port's f64 engine "
            "against the C++ engine; bars "
            f"{TOL_FIXED[0]:g} / {TOL_FIXED[1]:g} / {TOL_FIXED[2]:g}:", "",
            "| Functional | ngrid | dE_xc (Eh) | max dV_xc | max dJ | s |",
            "|---|---|---|---|---|---|"]
        lines += [f"| {r['functional']} | {r['ngrid']} | {r['de_xc']:.2e} | "
                  f"{r['dv_xc']:.2e} | {r['dj']:.2e}"
                  f"{'' if r['within'] else ' MISSED'} | {r['seconds']:.2f} |"
                  for r in cuo]
    if dha:
        lines += [
            "", "DHA (C14H12O2, nao 152) B3LYP at its SAD density on full "
            "grid-1 planes, E_xc and V_xc against the C++ engine on the same "
            f"planes (f64 bars {TOL_DHA[0]:g} / {TOL_DHA[1]:g}; K1 within its "
            f"contract, relative {TOL_K1[0]:g} / max dV {TOL_K1[1]:g}, against "
            "the C++ engine and the f64 engine):", "",
            "| Engine | ngrid | dE_xc (Eh) | max dV_xc | K1 vs f64 rel dE / "
            "max dV |", "|---|---|---|---|---|"]
        for r in dha:
            k1 = (f"{r['rel_de_vs_f64']:.2e} / {r['dv_vs_f64']:.2e}"
                  if "rel_de_vs_f64" in r else "")
            lines.append(f"| {r['engine']} | {r['ngrid']} | {r['de_xc']:.2e}"
                         f" | {r['dv_xc']:.2e}"
                         f"{'' if r['within'] else ' MISSED'} | {k1} |")
        lines.append("")
        lines.append(f"The C++ engine's DHA E_xc/V_xc took "
                     f"{dha[0]['native_s']:.2f} s on the host.")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out", nargs="?", default=os.path.join(
        ROOT, "docs", "oracle_diffs_h100.md"))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)

    import torch_kernel_timing as kt

    from quantum_compute_dft_tpu_torch.runtime import build_library

    head = kt.card(args.device)
    dev = torch.device(args.device)
    build_library()
    scf = []
    for name, fn, df, _ in ROWS:
        for xc_impl in XC_IMPLS:
            r = scf_row(name, fn, df, xc_impl, dev)
            print(json.dumps(r), flush=True)
            scf.append(r)
    cuo = cuo_rows(dev)
    dha = dha_rows(dev)
    for r in cuo + dha:
        print(json.dumps(r), flush=True)
    with open(args.out, "w") as f:
        f.write(_md(head, scf, cuo, dha))
    ok = all(r["within"] for r in scf + cuo + dha)
    print(json.dumps({"out": args.out, "rows": len(scf + cuo + dha),
                      "within": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
