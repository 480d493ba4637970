"""The port's SCF checkpoints (scf/checkpoint.py, scf_host's checkpoint_cb
and the CLI's --checkpoint) against the JAX package's, on the CPU.

Ports of tests/test_aux.py's test_checkpoint_roundtrip_and_resume,
test_midrun_checkpoint_resume (on scf_host with checkpoint_cb, the port's
one host loop) and test_cli_checkpoint_flow (through the port's CLI with
--device cpu), with their asserts; the files are also read across the two
packages (the same .npz format), and the CLI resumes only when nao,
molecule and functional all match.  The energies of a resumed run are held
to 1e-8 Eh of the uninterrupted run's, as in the originals.
"""

import os

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.scf.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
)
from quantum_compute_dft_tpu.scf.checkpoint import (
    save_checkpoint as jax_save_checkpoint,
)
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.mol import from_atoms
from quantum_compute_dft_tpu_torch.scf import (
    load_checkpoint,
    save_checkpoint,
    scf_host,
)
from quantum_compute_dft_tpu_torch.scf.checkpoint import periodic_saver

torch.set_num_threads(1)

H2O = [
    ("O", (0.0, 0.0, 0.127)),
    ("H", (0.0, 0.758, -0.509)),
    ("H", (0.0, -0.758, -0.509)),
]
H2_XYZ = "2\nH2\nH 0 0 0\nH 0 0 0.74084823\n"


@pytest.fixture(scope="module")
def setup():
    return kohn_sham.prepare(from_atoms(H2O), "LDA", grid_level=1,
                             device="cpu")


def test_checkpoint_roundtrip_and_resume(setup, tmp_path):
    res = scf_host(setup.sys, setup.functional)
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, res.dm, res.e_tot, res.n_iter, "LDA", "H2O")
    ck = load_checkpoint(p)
    assert ck["functional"] == "LDA"
    assert abs(ck["e_tot"] - res.e_tot) < 1e-12
    # the same file format as the JAX package's, both ways
    jck = jax_load_checkpoint(p)
    assert np.array_equal(jck["dm"], res.dm.numpy())
    assert (jck["cycle"], jck["molecule"]) == (res.n_iter, "H2O")
    pj = str(tmp_path / "jax.npz")
    jax_save_checkpoint(pj, res.dm.numpy(), res.e_tot, res.n_iter, "LDA",
                        "H2O")
    assert np.array_equal(load_checkpoint(pj)["dm"], ck["dm"])
    # resuming from the converged density converges immediately
    res2 = scf_host(setup.sys, setup.functional, dm0=ck["dm"])
    assert res2.converged
    assert res2.n_iter <= 3
    assert abs(res2.e_tot - res.e_tot) < 1e-8


def test_midrun_checkpoint_resume(setup, tmp_path):
    """Periodic mid-run checkpointing: interrupt the loop after a few
    cycles via max_cycle, with a periodic saver firing every 2 cycles;
    resuming from the last saved (non-converged) density must reproduce
    the uninterrupted run's converged energy to 1e-8."""
    p = str(tmp_path / "mid.npz")
    r_full = scf_host(setup.sys, setup.functional)
    saves = []
    saver = periodic_saver(p, "LDA", "H2O")

    def cb(cycle, dm, e_tot):
        saves.append((cycle, e_tot))
        saver(cycle, dm, e_tot)

    # "crash" at cycle 4: the run is cut off unconverged, but the saver
    # has checkpointed the in-progress density
    r_cut = scf_host(setup.sys, setup.functional, max_cycle=4,
                     checkpoint_cb=cb, checkpoint_every=2)
    assert not r_cut.converged and os.path.exists(p)
    assert [c for c, _ in saves] == [2, 4]
    ck = load_checkpoint(p)
    assert 0 < ck["cycle"] <= 4
    assert ck["e_tot"] == saves[-1][1]
    r_res = scf_host(setup.sys, setup.functional, dm0=ck["dm"])
    assert r_res.converged
    assert r_res.n_iter < r_full.n_iter  # warm start saves cycles
    assert abs(r_res.e_tot - r_full.e_tot) < 1e-8


def _cli(argv):
    from quantum_compute_dft_tpu_torch.cli import main

    # the JAX CLI runs its f64 host loop on the CPU; so does this one
    return main([*argv, "--grid-level", "1", "--device", "cpu",
                 "--xc-impl", "f64"])


def test_cli_checkpoint_flow(tmp_path, capsys):
    xyz = tmp_path / "h2.xyz"
    xyz.write_text(H2_XYZ)
    ck = str(tmp_path / "h2.npz")
    rc = _cli(["LDA", str(xyz), "--checkpoint", ck])
    assert rc == 0 and os.path.exists(ck)
    rc = _cli(["LDA", str(xyz), "--checkpoint", ck])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Resuming from checkpoint" in out


@pytest.mark.parametrize("mismatch", ["nao", "molecule", "functional"])
def test_cli_checkpoint_resumes_only_on_match(tmp_path, capsys, mismatch):
    xyz = tmp_path / "h2.xyz"
    xyz.write_text(H2_XYZ)
    ck = str(tmp_path / "h2.npz")
    nao = 3 if mismatch == "nao" else 2
    save_checkpoint(ck, np.eye(nao), -1.0, 5,
                    "PBE" if mismatch == "functional" else "LDA",
                    "other.xyz" if mismatch == "molecule" else "h2.xyz")
    rc = _cli(["LDA", str(xyz), "--checkpoint", ck])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Resuming from checkpoint" not in out
    assert {"nao": "nao=3 != 2", "molecule": "skipping resume",
            "functional": "skipping resume"}[mismatch] in out
    # the run overwrote the file with its own converged density
    assert load_checkpoint(ck)["dm"].shape == (2, 2)
