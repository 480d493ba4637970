"""The port's rescue tool (tools/torch_rescue_ladder.py) against the JAX
package's (tools/rescue_staged_ladder.py).

The seven cases of tests/test_rescue.py on the port's tool: the RESCUE_*
parsing (full and defaults), an end-to-end ladder on H2O/LDA grid 1 with
RESCUE_SAVE_DM (the saved density equal to the result's within 1e-12),
RESCUE_DM0 reaching the ladder, and the loose-rung re-tighten protocol
(success, failure -> None, no re-tighten without loosened tolerances).
Then one cross-check: the same env (RESCUE_XC=f64, RESCUE_KTS=0.2) through
both tools on H2O/LDA grid 1, the JAX tool with the JAX scf_host as its
runner; the energies agree within 1e-8 Eh (the two f64 drivers agree to
<= 1.5e-10 Eh on the golden rows; the margin covers a ladder's extra
cycles).  Last, the protocol search tool's table (each warm start names
an earlier protocol; tools/torch_rescue_search.py) and its refusal to run
without a card, and the integer-finish witness (tools/rescue_integer_finish.py)
on H2O/B3LYP grid 1: both packages' runs converge alike, energies within
CROSS_TOL.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_rescue_ladder as tool  # noqa: E402

from quantum_compute_dft_tpu_torch import kohn_sham  # noqa: E402
from quantum_compute_dft_tpu_torch.mol import from_atoms  # noqa: E402
from quantum_compute_dft_tpu_torch.scf.driver import SCFResult  # noqa: E402

torch.set_num_threads(1)

H2O = [
    ("O", (0.0, 0.0, 0.127)),
    ("H", (0.0, 0.758, -0.509)),
    ("H", (0.0, -0.758, -0.509)),
]
CROSS_TOL = 1e-8


@pytest.fixture(scope="module")
def h2o_lda():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DFT_SETUP_CACHE", "0")
        return kohn_sham.prepare(from_atoms(H2O), "LDA", grid_level=1,
                                 device="cpu")


def test_env_parsing_full(tmp_path):
    dm = np.eye(3)
    p = tmp_path / "dm0.npy"
    np.save(p, dm)
    env = {
        "RESCUE_MIXER": "adiis+cdiis",
        "RESCUE_XC": "f64",
        "RESCUE_KTS": "0.5,0.2,0.1",
        "RESCUE_MAX_CYCLE": "77",
        "RESCUE_RUNG_TOL_D": "1e-4",
        "RESCUE_RUNG_TOL_E": "1e-6",
        "RESCUE_ALPHA": "0.35",
        "RESCUE_DM0": str(p),
    }
    mixer, xc_impl, extra = tool.parse_env_hooks(env)
    assert mixer == "adiis+cdiis"
    assert xc_impl == "f64"
    assert extra["kts"] == (0.5, 0.2, 0.1)
    assert extra["max_cycle"] == 77
    assert extra["rung_conv_tol_d"] == 1e-4
    assert extra["rung_conv_tol_e"] == 1e-6
    assert extra["mix_alpha"] == 0.35
    assert np.array_equal(extra["dm0"], dm)


def test_env_parsing_defaults():
    mixer, xc_impl, extra = tool.parse_env_hooks({})
    assert mixer == "cdiis"
    assert xc_impl == "fast"
    assert extra == {}


def test_rescue_end_to_end_save_dm(tmp_path, h2o_lda):
    """The real ladder on H2O: the env's kts and schedule reach
    scf_host_annealed, the run converges, and RESCUE_SAVE_DM persists the
    final density."""
    out = tmp_path / "dm_final.npy"
    env = {"RESCUE_XC": "f64", "RESCUE_SAVE_DM": str(out),
           "RESCUE_KTS": "0.2"}
    r = tool.rescue_system(h2o_lda.sys, h2o_lda.functional, env=env)
    assert r is not None and r.converged
    assert out.exists()
    dm_saved = np.load(out)
    assert np.abs(dm_saved - r.dm.cpu().numpy()).max() < 1e-12


def test_rescue_dm0_warm_start_reaches_ladder(tmp_path, h2o_lda):
    """RESCUE_DM0 arrives at the annealed runner as its dm0 keyword."""
    n = h2o_lda.sys.hcore.shape[0]
    dm0 = np.eye(n) * 0.1
    p = tmp_path / "warm.npy"
    np.save(p, dm0)
    seen = {}

    def fake_annealed(sys_, functional, runner=None, **kw):
        seen.update(kw)
        return SCFResult(True, 1, np.eye(n), None, -1.0)

    r = tool.rescue_system(h2o_lda.sys, h2o_lda.functional,
                           env={"RESCUE_DM0": str(p)},
                           annealed_fn=fake_annealed)
    assert r.converged
    assert np.array_equal(seen["dm0"], dm0)


def _mk_res(conv, kt, e=-1.0, n=2):
    return SCFResult(conv, 5, np.eye(n), None, e, smear_kt=kt)


def test_loose_rung_retighten_success():
    """A smeared rung converged under loosened tolerances is re-run at the
    full rule; when that converges, its result (tagged with the rung's kT)
    is returned."""
    calls = {}

    def fake_annealed(sys_, functional, runner=None, **kw):
        return _mk_res(True, 0.2)  # loose smeared rung

    def fake_runner(sys_, functional, smear_kt=0.0, dm0=None, **kw):
        calls["smear_kt"] = smear_kt
        calls["dm0"] = dm0
        return _mk_res(True, 0.0, e=-2.0)

    r = tool.rescue_system(object(), object(),
                           env={"RESCUE_RUNG_TOL_D": "1e-4"},
                           annealed_fn=fake_annealed, runner=fake_runner)
    assert calls["smear_kt"] == 0.2      # tightened at the same rung kT
    assert calls["dm0"] is not None      # warm-started from the rung dm
    assert r.e_tot == -2.0
    assert r.smear_kt == 0.2             # recorded as the FON state it is


def test_loose_rung_retighten_failure_returns_none():
    """If the full-rule re-run fails, the loose rung alone does not count
    as converged."""
    def fake_annealed(sys_, functional, runner=None, **kw):
        return _mk_res(True, 0.2)

    def fake_runner(sys_, functional, smear_kt=0.0, dm0=None, **kw):
        return _mk_res(False, 0.0)

    r = tool.rescue_system(object(), object(),
                           env={"RESCUE_RUNG_TOL_D": "1e-4"},
                           annealed_fn=fake_annealed, runner=fake_runner)
    assert r is None


def test_no_retighten_without_loose_tols():
    """Without loosened rung tolerances the ladder's own result stands: no
    extra run."""
    def fake_annealed(sys_, functional, runner=None, **kw):
        return _mk_res(True, 0.2)

    def fail_runner(*a, **kw):  # must never be called
        raise AssertionError("re-tighten must not fire")

    r = tool.rescue_system(object(), object(), env={},
                           annealed_fn=fake_annealed, runner=fail_runner)
    assert r.converged and r.smear_kt == 0.2


def test_rescue_matches_jax_tool(h2o_lda):
    """The same env through the JAX tool (the JAX scf_host as its runner)
    and the port's: converged at the same kT, energies within CROSS_TOL."""
    from rescue_staged_ladder import rescue_system as jax_rescue

    from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
    from quantum_compute_dft_tpu.mol import from_atoms as jax_from_atoms
    from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host

    def jax_runner(sys_, functional, xc_impl="f64", **kw):
        # the JAX scf_host is the f64 loop and takes no xc_impl
        assert xc_impl == "f64"
        return jax_scf_host(sys_, functional, **kw)

    env = {"RESCUE_XC": "f64", "RESCUE_KTS": "0.2"}
    jax_setup = jax_kohn_sham.prepare(jax_from_atoms(H2O), "LDA",
                                      grid_level=1)
    r_jax = jax_rescue(jax_setup.sys, jax_setup.functional, env=env,
                       staged_fn=jax_runner)
    r = tool.rescue_system(h2o_lda.sys, h2o_lda.functional, env=env)
    assert r_jax is not None and r is not None
    assert r_jax.converged and r.converged
    assert r.smear_kt == r_jax.smear_kt
    assert abs(r.e_tot - float(r_jax.e_tot)) < CROSS_TOL


def test_search_table_chains_in_order():
    """Each protocol of the search tool's table runs on a grid level the
    JAX sweep used, on knobs the tool parses, and a warm start names a
    protocol listed before it (the default run takes them in order)."""
    import torch_rescue_search as search

    seen = set()
    for name, (level, knobs, start) in search.PROTOCOLS.items():
        assert level in (1, 3)
        assert set(knobs) <= {"RESCUE_XC", "RESCUE_MIXER", "RESCUE_ALPHA",
                              "RESCUE_KTS", "RESCUE_MAX_CYCLE",
                              "RESCUE_RUNG_TOL_D", "RESCUE_RUNG_TOL_E"}
        _, xc_impl, extra = tool.parse_env_hooks(knobs)
        assert xc_impl == "f64" and extra["kts"][-1] == 0.015
        assert "dm0" not in extra
        assert start is None or start in seen
        seen.add(name)
    assert search.MOLECULE == "ABAQ"


def test_search_refuses_without_card(tmp_path):
    """The search tool runs on the card only: without one it exits non-zero
    and writes nothing."""
    out = tmp_path / "search.json"
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_rescue_search.py"),
         str(out)], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and "no CUDA device" in p.stderr
    assert not out.exists()


def test_integer_finish_tool_on_h2o(tmp_path, monkeypatch):
    """The witness tool's three runs in each package (kT 0.015, then the
    CDIIS and mix+cdiis integer finishes) on H2O/B3LYP grid 1 from a SAD
    density: the same convergence in both, energies within CROSS_TOL."""
    import json

    import rescue_integer_finish as witness

    from quantum_compute_dft_tpu_torch.scf.driver import initial_guess

    monkeypatch.setenv("DFT_SETUP_CACHE", "0")
    monkeypatch.setattr(witness, "MOLECULE", "H2O")
    setup = kohn_sham.prepare(from_atoms(H2O), "B3LYP", grid_level=1,
                              device="cpu")
    dm = tmp_path / "dm.npy"
    np.save(dm, initial_guess(setup.sys).numpy())
    out = tmp_path / "out.json"
    assert witness.main([str(dm), str(out)]) == 0
    res = json.loads(out.read_text())
    assert (res["molecule"], res["grid_level"]) == ("H2O", 1)
    rows = {(r["package"], r["what"], r["mixer"]): r for r in res["rows"]}
    assert len(rows) == 6
    for what, _, mixer in witness.RUNS:
        j, p = rows[("jax", what, mixer)], rows[("port", what, mixer)]
        assert j["converged"] and p["converged"]
        assert abs(j["e_tot"] - p["e_tot"]) < CROSS_TOL
