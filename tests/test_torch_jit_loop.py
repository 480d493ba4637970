"""The port's scf_jit (the JAX package's whole-SCF device loop; CUDA
graphs on the card, tests/test_torch_gpu.py) on the CPU, its graph-safe
CDIIS, and the CLI's --jit-loop.

Tolerances: scf_jit against the port's scf_host f64, 1e-9 Eh
(tests/test_scf.py's bar for the JAX pair; the same f64 arithmetic from the
same guess); against the JAX package's scf_jit on the same setup arrays,
1e-9 Eh and the same cycle count; the graph-safe CDIIS against diis_update
over 12 steps (the 8-slot history wraps), 1e-12 (the same operations).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.basis.basis_set import (
    sad_occupations as jax_sad_occupations,
)
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.driver import scf_jit as jax_scf_jit
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.diis import (
    diis_init,
    diis_init_graph,
    diis_update,
    diis_update_graph,
)
from quantum_compute_dft_tpu_torch.scf.driver import (
    _jit_carry,
    _jit_cycle,
    _run_cycle,
    scf_host,
    scf_jit,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _xyz(name):
    return os.path.join(ROOT, "molecules", name + ".xyz")


@pytest.mark.parametrize("functional,density_fit", [
    ("B3LYP", False), ("B3LYP", True), ("LDA", False)])
def test_scf_jit_matches_scf_host(functional, density_fit):
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), functional,
                              grid_level=1, density_fit=density_fit,
                              device="cpu")
    ref = scf_host(setup.sys, setup.functional, xc_impl="f64")
    dm, eb, n_iter, done = scf_jit(setup.sys, setup.functional)
    assert ref.converged and done and n_iter == ref.n_iter
    assert abs(eb.e_tot - ref.e_tot) < 1e-9
    assert abs(sum(eb[1:]) + setup.sys.e_nuc - eb.e_tot) < 1e-10
    assert torch.allclose(dm, ref.dm, rtol=0.0, atol=1e-9)


def test_scf_jit_matches_jax_scf_jit():
    jmol = jax_from_xyz_file(_xyz("H2O"))
    js = jax_kohn_sham.prepare(jmol, "B3LYP", grid_level=1)
    dm_j, eb_j, n_j, done_j = jax_scf_jit(js.sys, js.functional)
    s = js.sys
    sad = jax_sad_occupations(jax_build_basis(jmol), jmol.charges, jmol.nelec)
    setup = kohn_sham.setup_from_arrays(
        np.asarray(s.hcore), np.asarray(s.s), np.asarray(s.eri),
        np.asarray(s.ao), np.asarray(s.ao_grad), np.asarray(s.weights),
        s.e_nuc, s.nocc, s.nopen, sad, "B3LYP", device="cpu")
    # the JAX package's GGA potential (jax_potential)
    dm, eb, n_iter, done = scf_jit(setup.sys,
                                   setup.functional.jax_potential())
    assert bool(done_j) and done
    assert n_iter == int(n_j)
    assert abs(eb.e_tot - float(eb_j.e_tot)) < 1e-9


def test_scf_jit_stops_at_max_cycle():
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "LDA",
                              grid_level=1, device="cpu")
    dm, eb, n_iter, done = scf_jit(setup.sys, setup.functional, max_cycle=3)
    assert n_iter == 3 and not done
    _, eb0, n0, done0 = scf_jit(setup.sys, setup.functional, max_cycle=0)
    assert n0 == 0 and not done0 and eb0.e_tot == 0.0


def test_cycle_after_done_changes_nothing():
    # the masked cycle: what the card's replays after convergence run
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "B3LYP",
                              grid_level=1, device="cpu")
    st = _jit_carry(setup.sys)
    for _ in range(40):
        _run_cycle(_jit_cycle(setup.sys, setup.functional, st, 200))
        if bool(st["done"]):
            break
    assert bool(st["done"])
    before = {k: v.clone() for k, v in st.items()}
    for _ in range(3):
        _run_cycle(_jit_cycle(setup.sys, setup.functional, st, 200))
    for k, v in st.items():
        assert torch.equal(v, before[k]), k


def test_graph_cdiis_matches_diis_update():
    rng = np.random.default_rng(5)
    n = 6
    a = rng.standard_normal((n, n))
    s = a @ a.T / n + np.eye(n)
    w, v = np.linalg.eigh(s)
    s, x = torch.tensor(s), torch.tensor((v / np.sqrt(w)) @ v.T)
    st, sg = diis_init(n), diis_init_graph(n)
    for step in range(12):
        f = torch.tensor(rng.standard_normal((n, n)))
        d = torch.tensor(rng.standard_normal((n, n)))
        st, f_ref = diis_update(st, f + f.T, d + d.T, s, x)
        sg, f_got = diis_update_graph(sg, f + f.T, d + d.T, s, x)
        assert int(sg.nsaved) == st.nsaved == step + 1
        assert torch.abs(f_got - f_ref).max() < 1e-12, step
        assert torch.equal(sg.f_buf, st.f_buf)


def test_cli_jit_loop():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "quantum_compute_dft_tpu_torch", "B3LYP",
         "H2O", "--grid-level", "1", "--device", "cpu", "--jit-loop"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Converged in" in out.stdout and "epoch" not in out.stdout
    e = float(out.stdout.split("Total energy :")[1].split()[0])
    setup = kohn_sham.prepare(from_xyz_file(_xyz("H2O")), "B3LYP",
                              grid_level=1, device="cpu")
    assert abs(e - scf_host(setup.sys, setup.functional).e_tot) < 1e-8
