"""The port's 'pallas' schedule (scf_host(xc_impl='pallas'): every cycle's
XC from the fused f32 kernel, J and K in f64, the plain convergence rule,
the cycle's own energies) against the JAX package's
scf_host_staged(xc_impl='pallas') with its Pallas kernel in interpret mode
(DFT_PALLAS_INTERPRET=1, as tests/test_lean_ao.py runs it), both on the
JAX package's setup arrays, and the CLI's --xc-impl pallas.

Tolerances: the two schedules' energies within 2e-5 |E_xc| (the bar of
tests/test_torch_fused_xc.py between the plain f32 kernel and the Pallas
kernel, whose own E_xc sits 1.2e-5 from the f64 engine); each within the
kernel's contract of the f64 energy, 5e-5 |E_xc| (tests/test_pallas.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import quantum_compute_dft_tpu.engine.pallas_xc as px
from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.basis.basis_set import (
    sad_occupations as jax_sad_occupations,
)
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.driver import (
    scf_host_staged as jax_scf_host_staged,
)
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.scf.driver import scf_host

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("DFT_PALLAS_INTERPRET", "1")
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(px.pl, "pallas_call", patched)


@pytest.mark.parametrize("functional", ["LDA", "B3LYP"])
def test_pallas_schedule_matches_jax(interpret, functional):
    jmol = jax_from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz"))
    js = jax_kohn_sham.prepare(jmol, functional, grid_level=1)
    ref = jax_scf_host_staged(js.sys, js.functional, xc_impl="pallas")
    s = js.sys
    sad = jax_sad_occupations(jax_build_basis(jmol), jmol.charges, jmol.nelec)
    setup = kohn_sham.setup_from_arrays(
        np.asarray(s.hcore), np.asarray(s.s), np.asarray(s.eri),
        np.asarray(s.ao), None if s.ao_grad is None else np.asarray(s.ao_grad),
        np.asarray(s.weights), s.e_nuc, s.nocc, s.nopen, sad, functional,
        device="cpu")
    res = scf_host(setup.sys, setup.functional, xc_impl="pallas")
    f64 = scf_host(setup.sys, setup.functional, xc_impl="f64")
    assert ref.converged and res.converged and f64.converged
    assert res.fast_cycles == res.n_iter and res.verify_cycles == 0
    e_xc = abs(f64.energy.e_xc)
    assert abs(res.e_tot - float(ref.e_tot)) < 2e-5 * e_xc
    assert abs(res.e_tot - f64.e_tot) < 5e-5 * e_xc
    assert abs(float(ref.e_tot) - f64.e_tot) < 5e-5 * e_xc


def test_cli_pallas():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "quantum_compute_dft_tpu_torch", "GGA", "H2O",
         "--grid-level", "1", "--device", "cpu", "--xc-impl", "pallas"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Converged in" in out.stdout
    assert "[fused f32 plain (cpu) engine]" in out.stdout
