"""The port's SCF against the JAX package, the golden energies and the HF
literature value.

Tolerances: SCF fed the JAX package's setup arrays vs the JAX scf_host,
1e-9 Eh (same f64 arithmetic, converged to |dE| < 1e-8 from the same
guess); the port's own setup + SCF vs tests/golden_energies.json, the
golden tolerance 1e-7 Eh; HF/STO-3G H2O vs the literature, 1e-5 Eh (its
printed digits); the 'fast' schedule (plain f32 XC on the CPU, then f64
verify) vs the f64 schedule, 1e-7 Eh (the f64 verify step re-converges to
the f64 fixed point); DIIS extrapolation vs the JAX package, 1e-12;
kohn_sham.run of both packages, 1e-9 Eh (their setups agree to ~1e-10 Eh
on H2O).
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.basis.basis_set import (
    sad_occupations as jax_sad_occupations,
)
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.diis import diis_init as jax_diis_init
from quantum_compute_dft_tpu.scf.diis import diis_update as jax_diis_update
from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.diis import diis_init, diis_update
from quantum_compute_dft_tpu_torch.scf.driver import scf_host

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


def _golden(molecule, functional):
    with open(os.path.join(ROOT, "tests", "golden_energies.json")) as f:
        g = json.load(f)
    for r in g["rows"]:
        if r["molecule"] == molecule and r["functional"] == functional:
            return r, g["tolerance"]
    raise KeyError((molecule, functional))


def test_scf_from_jax_setup_matches_jax_scf():
    jmol = jax_from_xyz_file(_xyz("H2O"))
    js = jax_kohn_sham.prepare(jmol, "LDA", grid_level=1)
    ref = jax_scf_host(js.sys, js.functional)
    s = js.sys
    sad = jax_sad_occupations(jax_build_basis(jmol), jmol.charges, jmol.nelec)
    setup = kohn_sham.setup_from_arrays(
        np.asarray(s.hcore), np.asarray(s.s), np.asarray(s.eri),
        np.asarray(s.ao), None, np.asarray(s.weights), s.e_nuc, s.nocc,
        s.nopen, sad, "LDA", device="cpu")
    res = scf_host(setup.sys, setup.functional)
    assert ref.converged and res.converged
    assert abs(res.e_tot - ref.e_tot) < 1e-9


@pytest.mark.parametrize("molecule,functional", [("H2O", "LDA"),
                                                 ("NH3", "GGA")])
def test_golden_rows(molecule, functional):
    row, tol = _golden(molecule, functional)
    setup = kohn_sham.prepare(from_xyz_file(_xyz(molecule)), functional,
                              grid_level=row["grid_level"], device="cpu")
    # the golden rows carry the JAX package's GGA potential (jax_potential)
    res = scf_host(setup.sys, setup.functional.jax_potential())
    assert res.converged
    assert abs(res.e_tot - row["e_tot"]) < tol


def test_hf_literature():
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "HF", grid_level=1,
                              device="cpu")
    res = scf_host(setup.sys, setup.functional)
    assert res.converged
    assert abs(res.e_tot - (-74.965901)) < 1e-5


def test_fast_schedule_matches_f64():
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "GGA", grid_level=1,
                              device="cpu")
    ref = scf_host(setup.sys, setup.functional)
    res = scf_host(setup.sys, setup.functional, xc_impl="fast")
    assert ref.converged and res.converged
    assert res.fast_cycles > 0 and res.verify_cycles > 0
    assert res.n_iter == res.fast_cycles + res.verify_cycles
    assert res.handover in ("rule", "streak") and ref.handover is None
    assert abs(res.e_tot - ref.e_tot) < 1e-7


@pytest.mark.parametrize("limit,df", [(6, True), (7, False)])
def test_auto_rule_selects_df_above_limit(monkeypatch, limit, df):
    # H2O has nao 7: density-fitted above the limit, in-core at it; with
    # the setup cache off, so that df_time is this factorization's
    monkeypatch.setattr(kohn_sham, "AUTO_DF_NAO", limit)
    monkeypatch.setenv("DFT_SETUP_CACHE", "0")
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "LDA",
                              grid_level=1, device="cpu")
    s = setup.sys
    assert (s.eri is None) == df and (s.df_bq is not None) == df
    assert s.df_l is None and s.df_bq32 is None   # LDA builds no K
    assert (setup.df_time > 0.0) == df


def test_diis_matches_jax():
    rng = np.random.default_rng(2)
    n = 6
    a = rng.standard_normal((n, n))
    s = a @ a.T / n + np.eye(n)
    w, v = np.linalg.eigh(s)
    x = (v / np.sqrt(w)) @ v.T
    st, jst = diis_init(n), jax_diis_init(n)
    for _ in range(10):   # wraps the 8-slot history
        f = rng.standard_normal((n, n))
        f = f + f.T
        d = rng.standard_normal((n, n))
        d = d + d.T
        st, out = diis_update(st, *(torch.tensor(m) for m in (f, d, s, x)))
        jst, jout = jax_diis_update(jst, *(jnp.asarray(m)
                                           for m in (f, d, s, x)))
        assert np.abs(out.numpy() - np.asarray(jout)).max() < 1e-12


@pytest.mark.parametrize("entry", ["prepare", "run", "setup_from_arrays"])
def test_entry_points_default_to_the_gpu(monkeypatch, entry):
    """Without a GPU the entry points refuse to run unless device="cpu" is
    passed: the CPU is never taken silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mol = from_xyz_file(_xyz("H2O"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "setup_from_arrays":
            z = np.zeros((2, 2))
            kohn_sham.setup_from_arrays(z, z, None, np.zeros((4, 2)), None,
                                        np.zeros(4), 0.0, 1, 0,
                                        np.ones(2), "LDA")
        else:
            getattr(kohn_sham, entry)(mol, "LDA", grid_level=1)


def test_run_defaults_to_the_f64_schedule_as_jax():
    """kohn_sham.run takes the f64 schedule by default, as the JAX
    package's run; the two agree within 1e-9 Eh (the port's own setup
    against the JAX package's, then the same f64 loop)."""
    res = kohn_sham.run(from_xyz_file(_xyz("H2O")), "LDA", grid_level=1,
                        device="cpu")
    ref = jax_kohn_sham.run(jax_from_xyz_file(_xyz("H2O")), "LDA",
                            grid_level=1)
    assert res.converged and ref.converged
    assert res.fast_cycles == 0 and res.verify_cycles == res.n_iter
    assert abs(res.e_tot - ref.e_tot) < 1e-9


def test_golden_tool_cpu_mode(tmp_path):
    """tools/torch_run_all_molecules.py --golden on the CPU: each row
    within the table's 1e-7 Eh at the table's smear_kt."""
    out = tmp_path / "rows.json"
    run = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "torch_run_all_molecules.py"),
         str(out), "--golden", "H2/LDA", "H2O/LDA", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr
    with open(out) as f:
        doc = json.load(f)
    assert doc["header"]["mode"] == "golden"
    assert doc["header"]["xc_impl"] == "fast"
    rows = doc["rows"]
    assert sorted(rows) == ["H2/LDA", "H2O/LDA"]
    for key, row in rows.items():
        ref, tol = _golden(*key.split("/"))
        assert row["converged"] and row["within"], row
        assert abs(row["e_tot"] - ref["e_tot"]) < tol
        assert row["smear_kt"] == ref["smear_kt"] == row["smear_kt_golden"]
        assert row["setup_s"] > 0.0 and row["scf_s"] > 0.0
