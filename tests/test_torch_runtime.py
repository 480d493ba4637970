"""The port's native C++ host engine (runtime/): its dft_host.cpp against
the JAX package's, the C ABI against the port's f64 engine, the native SCF
against the port's scf_host and against the JAX package's native SCF, and
the CLI's --validate.

Tolerances are tests/test_runtime.py's: E_xc 1e-10 and V_xc 1e-9 against
the f64 engine (dual-number AD vs torch autodiff), J 1e-12 (the same
contraction); the native SCF's loop energy 1e-7 Eh from scf_host's (each
loop's energy carries first-order noise from where it stopped) and the two
final densities' stationary energies (energy_of_dm) 1e-8 Eh.  The port's
and the JAX package's run_native_scf on the same arrays, 1e-12 Eh (the same
loop over the same library).
"""

import difflib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import quantum_compute_dft_tpu.runtime.ffi as jax_ffi
from quantum_compute_dft_tpu.runtime import run_native_scf as jax_native_scf
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.engine.coulomb import coulomb_full
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.runtime import (
    HostSolverWrapper,
    build_library,
    run_native_scf,
)
from quantum_compute_dft_tpu_torch.scf.driver import (
    energy_of_dm,
    initial_guess,
    scf_host,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ toolchain")


@pytest.fixture(scope="module")
def lib():
    return build_library()


def _setup(functional):
    mol = from_xyz_file(os.path.join(ROOT, "molecules", "H2O.xyz"))
    return kohn_sham.prepare(mol, functional, grid_level=1, device="cpu")


def _host(a):
    return None if a is None else np.ascontiguousarray(a.numpy())


def _native_args(setup):
    s = setup.sys
    return (_host(s.hcore), _host(s.s), _host(s.eri), _host(s.ao),
            _host(s.weights), _host(s.ao_grad), s.e_nuc, s.nocc)


def test_source_is_the_jax_packages():
    """The port's dft_host.cpp is the JAX package's but for the sigma term
    of V_xc: the only lines of the JAX package's copy that the port's
    changes are those that formed B with 2 vsigma (the port's solver
    carries the factor, 4 for dE_xc/dD, 2 through DFT_SetSigmaFactor); the
    rest is the same, line for line."""
    src = os.path.join(ROOT, "quantum_compute_dft_tpu_torch", "runtime",
                       "dft_host.cpp")
    ref = os.path.join(ROOT, "quantum_compute_dft_tpu", "runtime",
                       "dft_host.cpp")
    with open(src) as f:
        port = f.read().splitlines()
    with open(ref) as f:
        jax = f.read().splitlines()
    ops = difflib.SequenceMatcher(None, jax, port,
                                  autojunk=False).get_opcodes()
    changed = [line for tag, i1, i2, _, _ in ops if tag != "equal"
               for line in jax[i1:i2]]
    assert changed == [
        "  return new HostSolver{type};",
        "      // accumulate V += phi (w vrho phi + 2 w vsig gdot)^T "
        "symmetric half",
        "          b_row[i] = wg * (vrho * phi[i] + 2.0 * vsig * gdot);"]


def test_library_builds_into_build_dir(lib):
    assert os.path.dirname(lib) == os.path.join(ROOT, "build", "runtime")
    assert build_library() == lib   # built once per source hash


@pytest.mark.parametrize("functional", ["LDA", "GGA", "B3LYP"])
def test_native_xc_matches_port_engine(lib, functional):
    setup = _setup(functional)
    s = setup.sys
    dm = initial_guess(s)
    e_ref, v_ref = xc_step(setup.functional, dm, s.ao, s.weights, s.ao_grad)
    vxc = np.zeros(dm.shape)
    exc = HostSolverWrapper(functional, lib).compute_xc(
        _host(dm), _host(s.ao), _host(s.weights), vxc, _host(s.ao_grad))
    assert abs(exc - float(e_ref)) < 1e-10
    assert np.abs(vxc - v_ref.numpy()).max() < 1e-9


def test_native_coulomb_matches(lib):
    s = _setup("LDA").sys
    dm = _host(initial_guess(s))
    n = dm.shape[0]
    out = np.zeros((n, n))
    HostSolverWrapper("LDA", lib).compute_coulomb(
        np.ascontiguousarray(_host(s.eri).reshape(n * n, n * n)), dm, out)
    ref = coulomb_full(s.eri, torch.from_numpy(dm)).numpy()
    assert np.abs(out - ref).max() < 1e-12


def test_invalid_solver_type(lib):
    with pytest.raises(KeyError):
        HostSolverWrapper("NOPE", lib)


@pytest.mark.parametrize("functional", ["LDA", "GGA", "B3LYP"])
def test_native_scf_matches_port_scf(lib, functional):
    setup = _setup(functional)
    res = scf_host(setup.sys, setup.functional, xc_impl="f64")
    e_nat, dm_nat, _, conv = run_native_scf(functional,
                                            *_native_args(setup))
    assert res.converged and conv
    assert abs(e_nat - res.e_tot) < 1e-7
    e_stat_nat = energy_of_dm(setup.sys, setup.functional,
                              torch.from_numpy(dm_nat)).e_tot
    e_stat = energy_of_dm(setup.sys, setup.functional, res.dm).e_tot
    assert abs(e_stat_nat - e_stat) < 1e-8


def test_native_scf_equals_the_jax_packages(lib, monkeypatch):
    # the JAX package's loop over the library built from the same source
    # (its own build writes into its package directory)
    monkeypatch.setattr(jax_ffi, "build_library", lambda force=False: lib)
    args = _native_args(_setup("GGA"))
    e, dm, n, conv = run_native_scf("GGA", *args)
    e_j, dm_j, n_j, conv_j = jax_native_scf("GGA", *args)
    assert conv and conv_j and n == n_j
    assert abs(e - e_j) < 1e-12
    assert np.abs(dm - dm_j).max() < 1e-12


@pytest.mark.parametrize("mode,expect", [
    ("native", "difference"), ("auto", "difference"),
    ("pyscf", "skipping validation")])
def test_cli_validate(lib, mode, expect):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "quantum_compute_dft_tpu_torch", "B3LYP",
         "H2O", "--grid-level", "1", "--device", "cpu", "--validate", mode],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
    if expect == "difference":
        text = out.stdout
        assert "native C++ (B3LYP) energy" in text
        e_nat = float(text.split("native C++ (B3LYP) energy :")[1].split()[0])
        e = float(text.split("Total energy :")[1].split()[0])
        assert abs(e_nat - e) < 1e-7
