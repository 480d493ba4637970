"""The comparison that decides `correct`, shown to fail.

On the CPU at the rehearsal's size (H2O, grid level 1, ``--device cpu``):
a whole run of the harness with the program's lower-precision path
(``--xc-impl pallas``) in the timed path's place comes out not correct
under the rehearsal's limit, set like the cells' from readings at its own
size; and a whole run of the harness (all but its look for a card)
comes out not correct when the timed path is broken underneath it: an SCF
step that returns its state unchanged, half of the grid's points left out
(the other half weighted double), and the energy altered where it is
produced.  A rerun cell whose jobs miss the setup cache fails them, and
a warm-up that fails ends the run.  The cells run on one card, so there
is no exchange between cards to leave out.

    python -m pytest -q bench_torch/tests
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_torch import control, harness  # noqa: E402

REHEARSAL = os.path.join(ROOT, "bench_torch", "rehearsal",
                         "h2o.sto3g.grid1.json")
CELLS = [w["name"] for w in harness.load_json(
    os.path.join(ROOT, "BENCHMARK.json"))["workloads"]]


def limit_of(workload: str) -> float:
    return harness.cell(workload)["config"]["energy_limit_eh"]


def test_control_is_not_correct():
    """The program's own f32 path (`--xc-impl pallas`) in the timed path's
    place comes out not correct."""
    res = _run(CELLS[0], jobs_cls=control.PallasJobs)
    assert res["failed"] == 0
    assert not res["correct"], res["compared"]


def _run(workload: str, **kw):
    return harness.run(workload, seed=2**31 + 5, seconds=0.1, trace=False,
                       t_start=time.perf_counter(), device="cpu",
                       config_path=REHEARSAL, **kw)


def test_sound_run_is_correct():
    res = _run(CELLS[0])
    assert res["correct"], res["compared"]


@pytest.fixture(params=["state_unchanged", "half_the_points",
                        "energy_altered"])
def fault(request, monkeypatch):
    from quantum_compute_dft_tpu_torch import kohn_sham
    from quantum_compute_dft_tpu_torch.grids import Grid
    from quantum_compute_dft_tpu_torch.scf import driver

    if request.param == "state_unchanged":
        tail = driver._cycle_tail

        def unchanged(sys, functional, dm, *a, **k):
            _, diis, energies = tail(sys, functional, dm, *a, **k)
            return dm, diis, energies

        monkeypatch.setattr(driver, "_cycle_tail", unchanged)
    elif request.param == "half_the_points":
        build = kohn_sham.build_grid

        def half(*a, **k):
            g = build(*a, **k)
            w = np.array(g.weights) * 2.0
            w[::2] = 0.0
            return Grid(g.coords, w, g.atom_idx)

        monkeypatch.setattr(kohn_sham, "build_grid", half)
    else:
        energy = driver.energy_of_dm
        shift = 10 * max(limit_of(w) for w in CELLS)

        def altered(*a, **k):
            eb = energy(*a, **k)
            return eb._replace(e_tot=eb.e_tot + shift)

        monkeypatch.setattr(driver, "energy_of_dm", altered)
    return request.param


@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(workload, fault):
    res = _run(workload)
    assert not res["correct"], (fault, res["compared"], res["failed"])


def test_warm_cell_that_misses_its_cache_is_not_correct(monkeypatch):
    """A rerun cell whose jobs find nothing in the setup cache (they run
    cold under a rerun cell's name) fails them."""
    from quantum_compute_dft_tpu_torch import setup_cache

    warm = [w for w in CELLS if harness.cell(w)["traffic"]["cache"] == "warm"]
    assert warm
    monkeypatch.setattr(setup_cache, "load", lambda *a, **k: None)
    for workload in warm:
        res = _run(workload)
        assert res["failed"] > 0 and not res["correct"], res["compared"]


def test_failed_warm_up_ends_the_run(monkeypatch):
    """A job of the warm-up that fails ends the run without a result."""
    from quantum_compute_dft_tpu_torch import cli

    def broken(argv):
        raise RuntimeError("planted")

    monkeypatch.setattr(cli, "run", broken)
    with pytest.raises(SystemExit, match="warm-up failed"):
        _run(CELLS[0])
