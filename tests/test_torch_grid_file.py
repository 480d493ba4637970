"""The port's 6-column grid-file loader (grids.load_grid_file, the
reference's init_grid path) against the JAX package's, an SCF on a grid
written and read back, and the CLI's --grid-file.

Tolerances: the two loaders on one file, exact (both are np.loadtxt and
the same column split); an SCF on the native grid written with 17
significant digits and read back against the SCF on the native grid,
1e-12 Eh (the same doubles, so the same arithmetic); the CLI's printed
energy (8 decimals) against the library's, 1e-8 Eh.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.grids import load_grid_file as jax_load_grid_file
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.grids import build_grid, load_grid_file
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.driver import scf_host

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mol(name="H2O"):
    return from_xyz_file(os.path.join(ROOT, "molecules", name + ".xyz"))


def _write(path, grid):
    np.savetxt(path, np.column_stack([grid.atom_idx, grid.coords,
                                      grid.weights, grid.weights]),
               fmt=["%d"] + ["%.17g"] * 5)


@pytest.fixture
def grid_file(tmp_path):
    grid = build_grid(_mol(), level=1)
    path = str(tmp_path / "h2o_L1.grid")
    _write(path, grid)
    return grid, path


@pytest.mark.parametrize("rows", [None, 1])
def test_loader_matches_jax(grid_file, tmp_path, rows):
    grid, path = grid_file
    if rows == 1:   # a one-row file is reshaped to (1, 6) by both loaders
        path = str(tmp_path / "one.grid")
        with open(grid_file[1]) as f:
            line = f.readline()
        with open(path, "w") as f:
            f.write(line)
    got, ref = load_grid_file(path), jax_load_grid_file(path)
    for name in ("coords", "weights", "atom_idx"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), name
    if rows is None:
        assert np.array_equal(got.coords, grid.coords)
        assert np.array_equal(got.weights, grid.weights)
        assert np.array_equal(got.atom_idx, grid.atom_idx)
    else:
        assert got.ngrid == 1 and got.coords.shape == (1, 3)


def test_scf_on_written_grid_matches_native(grid_file):
    _, path = grid_file
    native = kohn_sham.prepare(_mol(), "GGA", grid_level=1, device="cpu")
    filed = kohn_sham.prepare(_mol(), "GGA", grid=load_grid_file(path),
                              device="cpu")
    assert "grid" not in filed.cache_hits
    r0 = scf_host(native.sys, native.functional)
    r1 = scf_host(filed.sys, filed.functional)
    assert r0.converged and r1.converged
    assert abs(r1.e_tot - r0.e_tot) < 1e-12


def test_cli_grid_file(grid_file, tmp_path):
    _, path = grid_file
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               DFT_SETUP_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run(
        [sys.executable, "-m", "quantum_compute_dft_tpu_torch", "LDA", "H2O",
         "--grid-file", path, "--device", "cpu", "--xc-impl", "f64"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "grid points=" in out.stdout and "Converged in" in out.stdout
    n = int(out.stdout.split("grid points=")[1].split()[0])
    assert n == load_grid_file(path).ngrid
    setup = kohn_sham.prepare(_mol(), "LDA", grid_level=1, device="cpu")
    ref = scf_host(setup.sys, setup.functional)
    e = float(out.stdout.split("Total energy :")[1].split()[0])
    assert abs(e - ref.e_tot) < 1e-8
