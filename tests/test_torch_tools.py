"""The port's tools in their CPU modes at H2O size, against the JAX
package where it has the same tool: the oracle matrix (the port's SCF
against the C++ engine), the grid error study, the zeta sensitivity, the
zeta-table writer, the basis importer, the sweep's renderer and the
optimizer's trace helper.

Tolerances: an oracle row 1e-7 Eh (tests/test_runtime.py's in-core bar);
a grid study difference 1e-9 Eh of the JAX package's (two SCFs each
converged to |dE| < 1e-8 on the same grids, which the port and the JAX
package reach in the same cycles to ~1e-10 Eh); a zeta derivative 1e-8
of the JAX package's (energies that agree to ~1e-12 Eh over a step of
0.01 zeta).
"""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import atomic_scf as jax_atomic
from quantum_compute_dft_tpu.basis.data import ZETA as JAX_ZETA
from quantum_compute_dft_tpu.grids import build_grid as jax_build_grid
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import optimizer_trace  # noqa: E402
import torch_apply_optimized_zetas as apply_tool  # noqa: E402
import torch_grid_error_study as grid_study  # noqa: E402
import torch_import_basis as import_basis  # noqa: E402
import torch_optimize_heavy_zetas as opt_tool  # noqa: E402
import torch_oracle_diffs as oracle  # noqa: E402
import torch_results_md as results_md  # noqa: E402
import torch_zeta_sensitivity as sens  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ toolchain")
@pytest.mark.parametrize("xc_impl", ["fast", "f64"])
def test_oracle_row_h2o_lda(xc_impl):
    from quantum_compute_dft_tpu_torch.runtime import build_library

    build_library()
    row = oracle.scf_row("H2O", "LDA", False, xc_impl, torch.device("cpu"))
    assert row["converged"] and row["within"]
    assert row["de"] < 1e-7
    if xc_impl == "fast":
        assert row["fast_cycles"] > 0


def test_grid_study_level_difference_equals_jax():
    e1 = grid_study.energy("H2O", "LDA", 1, True, device="cpu")
    e2 = grid_study.energy("H2O", "LDA", 2, True, device="cpu")
    mol = jax_from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz"))
    ej = []
    for level, r in ((1, e1), (2, e2)):
        g = jax_build_grid(mol, level=level, prune=True)
        assert g.ngrid == r["ngrid"]
        s = jax_kohn_sham.prepare(mol, "LDA", grid=g)
        ej.append(jax_scf_host(s.sys, s.functional).e_tot)
    assert e1["converged"] and e2["converged"]
    diff = (e1["e_tot"] - e2["e_tot"]) - (ej[0] - ej[1])
    assert abs(diff) < 1e-9, diff


def test_zeta_derivative_equals_jax():
    d = sens.derivative("O", "2sp", device="cpu")
    zt = {sh: z for sh, (z, _) in JAX_ZETA["O"].items()}
    h = sens.REL_STEP * zt["2sp"]
    ep = jax_atomic.atomic_energy("O", dict(zt, **{"2sp": zt["2sp"] + h}))
    em = jax_atomic.atomic_energy("O", dict(zt, **{"2sp": zt["2sp"] - h}))
    assert abs(d - (ep - em) / (2 * h)) < 1e-8


def _load_module(path):
    spec = importlib.util.spec_from_file_location("zeta_written", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_apply_tool_round_trips_its_json(tmp_path):
    res = {"header": {"device": "cpu"},
           "Cu": {"zetas": {"1s": 28.4, "3d": 4.2, "4sp": 1.2},
                  "e_opt": -1619.1, "e_table": -1619.0, "frozen": "4sp"},
           "Mo": {"error": "RuntimeError()"}}
    src = tmp_path / "res.json"
    src.write_text(json.dumps(res))
    out = tmp_path / "zeta_written.py"
    apply_tool.apply(str(src), str(out))
    assert _load_module(out).OPTIMIZED == {"Cu": res["Cu"]["zetas"]}
    # a second run merges into the written table and replaces its rows
    src.write_text(json.dumps({"I": {"zetas": {"5sp": 2.0}},
                               "Cu": {"zetas": {"1s": 28.5}}}))
    apply_tool.apply(str(src), str(out))
    assert _load_module(out).OPTIMIZED == {"Cu": {"1s": 28.5},
                                           "I": {"5sp": 2.0}}
    with pytest.raises(SystemExit):   # the output module is required
        apply_tool.main([str(src)])


def test_optimizer_trace_equals_jax_and_restores():
    from quantum_compute_dft_tpu_torch.basis import atomic_scf

    energy = atomic_scf.atomic_energy
    zetas, e, trace = optimizer_trace.optimize_traced(
        atomic_scf, "H", sweeps=1, device="cpu")
    assert atomic_scf.atomic_energy is energy
    jz, je, jtrace = optimizer_trace.optimize_traced(jax_atomic, "H",
                                                     sweeps=1)
    assert zetas == jz and abs(e - je) < 1e-10
    assert len(trace) == len(jtrace) > 0
    for (z, ez), (zj, ezj) in zip(trace, jtrace):
        assert z == zj and abs(ez - ezj) < 1e-10


def test_optimizer_trace_raises_when_nothing_is_traced():
    import types

    mod = types.ModuleType("atomic_scf_bound_locally")

    def atomic_energy(symbol, zetas=None, **kw):
        return -sum(zetas.values())

    def optimize_zetas(symbol, **kw):   # binds the function, not the name
        return {"1s": 1.0}, atomic_energy(symbol, {"1s": 1.0})

    mod.atomic_energy, mod.optimize_zetas = atomic_energy, optimize_zetas
    with pytest.raises(RuntimeError, match="nothing was traced"):
        optimizer_trace.optimize_traced(mod, "H")
    assert mod.atomic_energy is atomic_energy


def test_optimize_tool_resumes_and_freezes(tmp_path):
    assert opt_tool.frozen_for("Cu") == ("4sp",)
    assert opt_tool.frozen_for("Mo") == ("5sp",)
    assert opt_tool.frozen_for("I") == ()
    assert len(opt_tool.ALL) == 34
    out = tmp_path / "opt.json"
    out.write_text(json.dumps({"Cu": {"zetas": {"4sp": 1.2}}}))
    assert opt_tool.main([str(out), "Cu", "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert doc["Cu"] == {"zetas": {"4sp": 1.2}}   # held, not rerun
    assert doc["header"]["device"] == "cpu"


def test_import_basis_finds_no_difference(tmp_path):
    dat = tmp_path / "sto-3g.dat"
    dat.write_text(import_basis.format_nwchem(["H", "C", "O", "Na", "Cu",
                                              "I"]))
    table = import_basis.to_shell_table(
        import_basis.parse_nwchem(dat.read_text()))
    diffs = import_basis.diff(table)
    assert sorted(diffs) == ["C", "Cu", "H", "I", "Na", "O"]
    assert all(d == (0.0, 0.0) for d in diffs.values()), diffs
    out = tmp_path / "sto3g_override.py"
    assert import_basis.main([str(dat), "--write", str(out)]) == 0
    assert _load_module(out).SHELLS == table


def test_tools_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for main in (sens.main, oracle.main, grid_study.main):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main([str(tmp_path / "x.md")])


def test_sweep_layout_compares_and_renders(tmp_path):
    out = tmp_path / "sweep.json"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "torch_run_all_molecules.py"),
         str(out), "H2O", "--grid-level", "1", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    doc = json.loads(out.read_text())
    assert sorted(doc) == ["H2O/B3LYP", "header"]
    row = doc["H2O/B3LYP"]
    assert row["converged"] and row["basis_provenance"] == ["canonical"]
    # tools/compare_sweeps.py reads the layout (grid 1 against the JAX
    # package's grid-3 row: a difference, flagged)
    cmp = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "compare_sweeps.py"),
         os.path.join(ROOT, "docs", "results_58_r5.json"), str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=60)
    assert "1 shared rows" in cmp.stdout, cmp.stdout
    md = tmp_path / "r.md"
    assert results_md.main([str(out), str(md)]) == 0
    text = md.read_text()
    assert "| H2O | B3LYP | 3 | 7 |" in text
    assert "Converged: **1/1** rows" in text
