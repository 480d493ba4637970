"""The port's CLI end to end on the CPU (explicit --device cpu), and the
refusal of the default --device cuda on a machine without a GPU."""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "quantum_compute_dft_tpu_torch", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("xc_impl", ["fast", "f64"])
def test_cli_cpu_end_to_end(xc_impl):
    out = _run("LDA", "H2O", "--grid-level", "1", "--device", "cpu",
               "--xc-impl", xc_impl)
    assert out.returncode == 0, out.stderr
    text = out.stdout
    assert "epoch" in text and "total energy" in text and "d-density" in text
    assert "Converged in" in text
    e = float(text.split("Total energy :")[1].split()[0])
    assert abs(e - (-74.73991504)) < 1e-7
    assert "XC(Exc+Vxc)" in text


def test_cli_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the default device is valid")
    out = _run("LDA", "H2O", "--grid-level", "1")
    assert out.returncode != 0
    assert "--device cpu" in out.stderr
