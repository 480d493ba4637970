"""tools/torch_northstar.py's setup and scf (which chip_smoke.py's phase 4e
calls too) and tools/torch_kernel_timing.py's bound, on the CPU.

Tolerances and why:
  * the SCF on a factor loaded from the cache against the same SCF on the
    factor just built: 1e-12 Eh (the .npz round trip is exact, so the two
    runs repeat the same f64 operations);
  * the bound: 1e-12 relative (the same arithmetic as its docstring's
    formula, in another order).
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch_kernel_timing as kt  # noqa: E402
import torch_northstar as ns  # noqa: E402

torch.set_num_threads(1)


def test_northstar_setup_caches_factor(tmp_path, monkeypatch):
    """setup() builds the Cholesky factor and saves it under CACHE; a second
    setup() loads it, and scf() on either gives the same energy."""
    monkeypatch.setattr(ns, "CACHE", str(tmp_path))
    runs = []
    for cached in (False, True):
        ks, factor = ns.setup("H2O", device="cpu")
        assert factor["cholesky_cached"] is cached
        assert ks.df_aux == "override" and ks.sys.eri is None
        assert factor["cd_rank"] == ks.sys.df_bq.shape[0]
        res, seconds = ns.scf(ks, "f64")
        assert res.converged and seconds > 0.0
        runs.append((factor["cd_rank"], res.e_tot))
    assert os.listdir(tmp_path) == [f"northstar_L_H2O_tol{ns.CD_TOL:g}.npz"]
    (rank0, e0), (rank1, e1) = runs
    assert rank0 == rank1 and abs(e0 - e1) < 1e-12


@pytest.mark.parametrize("kid, needs_grad, n, npts", [
    ("K1", True, 377, 540054), ("K2", False, 152, 91000),
    ("nophi", True, 152, 91000), ("nov", True, 36, 20000),
    ("K3", True, 152, 634880), ("K3", False, 152, 634880),
    ("phi3", True, 152, 634880)])
def test_xc_bound(kid, needs_grad, n, npts):
    ms, by, t_b, t_o, t_fp32 = kt.xc_bound(kid, needs_grad, n, npts)
    planes = 4 if needs_grad else 1
    nbytes = 8 * (2 * n * n + 1) + 4 * (planes * n + 1) * npts
    phi = 0 if kid == "nophi" else 2 * n * n * npts
    v = 0 if kid == "nov" else (2 * n * n if needs_grad else n * (n + 1)) * npts
    # K3 and phi3 form phi_D as the bf16 split, at the bf16 rate
    phi_rate = kt.BF16_FLOP_S if kid in ("K3", "phi3") else kt.TF32_FLOP_S
    assert t_b == pytest.approx(1e3 * nbytes / kt.HBM_BYTES_S, rel=1e-12)
    assert t_o == pytest.approx(
        1e3 * (phi / phi_rate + v / kt.TF32_FLOP_S), rel=1e-12)
    assert t_fp32 == pytest.approx(1e3 * (phi + v) / kt.FP32_FLOP_S, rel=1e-12)
    assert ms == max(t_b, t_o)
    assert by == ("bytes" if t_b >= t_o else "operations")
    if kid == "K1":   # the north star's whole grid: bytes set the bound
        assert by == "bytes" and ms == pytest.approx(0.9737, abs=1e-4)
    if kid in ("K3", "phi3"):   # DHA grid 3: bytes set it in both bodies
        assert by == "bytes"
