"""The result line's guard against JAX: a process that holds a module of
JAX, jaxlib, Flax or the JAX package once the window has closed exits 3,
names the module on stderr and prints no result; the port's own package,
whose name begins with the JAX package's, is not taken for it.

    python -m pytest -q bench_torch/tests/test_run.py
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_torch import harness  # noqa: E402


@pytest.fixture
def run(monkeypatch):
    """bench_torch/run.py as a module, its interpreter settings undone
    after the test, with a harness.run that returns a sound result at
    once."""
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    spec = importlib.util.spec_from_file_location(
        "bench_torch_run", os.path.join(ROOT, "bench_torch", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    gap = dict(value=0.0, limit=1e-8)
    monkeypatch.setattr(harness, "run", lambda *a, **k: dict(
        correct=True, attempted=1, failed=0, metrics={}, references={},
        compared={"energy_gap_LDA": gap}))
    return mod


def _main(run):
    return run.main(["--workload", "benzene.lda.cold", "--seed",
                     str(2**31 + 9), "--seconds", "1", "--rehearse"])


@pytest.mark.parametrize("name", [
    "jax", "jax.numpy", "jaxlib", "jaxlib.xla_client", "flax", "flax.linen",
    "quantum_compute_dft_tpu", "quantum_compute_dft_tpu.scf"])
def test_jax_module_stops_the_result(run, monkeypatch, capsys, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert _main(run) == 3
    out, err = capsys.readouterr()
    assert out == ""
    assert name in err


@pytest.mark.parametrize("name", [
    "quantum_compute_dft_tpu_torch", "quantum_compute_dft_tpu_torch.cli",
    "jaxtyping", "flaxen", "jaxlibrary"])
def test_other_module_is_not_taken_for_jax(run, monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name not in run.jax_loaded()
