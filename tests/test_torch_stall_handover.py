"""The 'fast' schedule's stall handover (scf/driver.py, STALL_*).

The rule alone on synthetic ||dD|| sequences: a floor like the north
star's kernel phase on the card (median 4.5e-5, dips to 4e-7) fires it; a
steady descent below conv_tol_d meets the streak first.  Then whole SCFs
at grid level 1 on the CPU, with conv_tol_d at 1e-11, below the plain f32
kernel's floor (~5e-10 to 1e-8 at H2S), so that neither the rule nor the
streak can end the kernel phase: the stall hands over, the f64 verify
converges, and the energy is the f64 schedule's within 1e-9 Eh (both
converged to 1e-11 Eh) and the plain reference's (bench_torch/reference,
on the program's own 3sp table) within 1e-8 Eh, as
bench_torch/tests/test_reference.py holds the f64 schedule.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu_torch import cli
from quantum_compute_dft_tpu_torch.scf import driver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2S = os.path.join(ROOT, "molecules", "H2S.xyz")
BELOW_FLOOR = ["--conv-tol-e", "1e-11", "--conv-tol-d", "1e-11"]


def _phase_end(dnorms, conv_tol_d=1e-6):
    """How and at which cycle scf_host's kernel phase would end on these
    ||dD|| (|dE| never small enough for the rule): the streak first, then
    the stall, as the loop tests them."""
    hist, streak = [], 0
    for i, dn in enumerate(dnorms):
        hist.append(dn)
        streak = streak + 1 if dn < conv_tol_d else 0
        if streak >= driver.FAST_DN_STREAK:
            return "streak", i
        if driver._stalled(hist, conv_tol_d):
            return "stall", i
    return None, len(dnorms)


def _descent(n, start, stop, rng):
    """n values falling geometrically from start to stop, each scaled by
    a factor drawn from [0.5, 2)."""
    return list(np.logspace(np.log10(start), np.log10(stop), n)
                * rng.uniform(0.5, 2.0, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_floor_like_the_northstars_fires(seed):
    rng = np.random.default_rng(seed)
    floor = 4.5e-5 * np.exp(rng.normal(0.0, 1.0, 170))
    floor[rng.choice(170, 6, replace=False)] = 4e-7   # the dips
    dnorms = _descent(30, 1.0, 4.5e-5, rng) + list(floor)
    assert np.median(dnorms[-50:]) > 1e-5
    how, at = _phase_end(dnorms)
    assert how == "stall"
    assert 30 <= at < 30 + 40


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_steady_descent_meets_the_streak_first(seed):
    rng = np.random.default_rng(seed)
    # ~0.25 decades a cycle to below 1e-6, then a floor near 1e-7
    dnorms = _descent(26, 1.0, 3e-7, rng) + list(
        1e-7 * rng.uniform(0.5, 2.0, 20))
    how, at = _phase_end(dnorms)
    assert how == "streak"


def test_rule_is_silent_below_the_criterion_and_above_the_ceiling():
    flat = [1.0] * 4 + [2e-7] * 30
    assert not any(driver._stalled(flat[:i + 1], 1e-6)
                   for i in range(len(flat)))
    high = [1.0] * 4 + [5e-3] * 30
    assert not any(driver._stalled(high[:i + 1], 1e-6)
                   for i in range(len(high)))


def _run(path, xc_impl, *extra):
    before = os.environ.get("DFT_SETUP_CACHE")
    os.environ["DFT_SETUP_CACHE"] = "0"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, res, _ = cli.run(["B3LYP", path, "--grid-level", "1",
                                 "--device", "cpu", "--xc-impl", xc_impl,
                                 "--density-fit", "off", *extra])
    finally:
        if before is None:
            os.environ.pop("DFT_SETUP_CACHE")
        else:
            os.environ["DFT_SETUP_CACHE"] = before
    return res


@pytest.fixture(scope="module")
def ph3(tmp_path_factory) -> str:
    """PH3 with P-H 1.42 Angstrom and H-P-H 93.3 degrees, as an .xyz (the
    geometry of bench_torch/tests/test_reference.py)."""
    r, cos = 1.42, np.cos(np.deg2rad(93.3))
    s2 = (1.0 - cos) / 1.5                  # so that u_i . u_j = cos
    z, s = np.sqrt(1.0 - s2), np.sqrt(s2)
    path = tmp_path_factory.mktemp("ph3") / "PH3.xyz"
    with open(path, "w") as f:
        f.write("4\nPH3\nP 0.0 0.0 0.0\n")
        for t in (0.0, 2 * np.pi / 3, 4 * np.pi / 3):
            x, y = r * s * np.cos(t), r * s * np.sin(t)
            f.write(f"H {float(x)!r} {float(y)!r} {float(-r * z)!r}\n")
    return str(path)


@pytest.fixture(scope="module")
def stalled(ph3):
    """{label: the stall-handover SCFResult} for H2S and PH3."""
    return {label: _run(path, "fast", *BELOW_FLOOR)
            for label, path in (("H2S", H2S), ("PH3", ph3))}


def test_h2s_stall_hands_over_to_the_f64_verify(stalled):
    res = stalled["H2S"]
    assert res.converged and res.handover == "stall"
    assert res.fast_cycles > driver.STALL_WINDOW and res.verify_cycles > 0
    assert res.n_iter == res.fast_cycles + res.verify_cycles
    assert 0 <= res.stall_wait_cycles < res.fast_cycles
    ref = _run(H2S, "f64", *BELOW_FLOOR)
    assert ref.converged and ref.handover is None
    assert abs(res.e_tot - ref.e_tot) < 1e-9


@pytest.mark.parametrize("label", ["H2S", "PH3"])
def test_stall_energy_is_the_references(stalled, ph3, monkeypatch, label):
    sys.path.insert(0, ROOT)
    from bench_torch import harness
    from bench_torch.reference import basis, rks
    from quantum_compute_dft_tpu_torch.basis import data

    res = stalled[label]
    assert res.converged and res.handover == "stall"
    monkeypatch.setitem(basis._FITS, "3sp", data.UNIVERSAL_FITS["3sp"])
    mol = basis.mol_from_angstrom(*harness.read_xyz(
        H2S if label == "H2S" else ph3))
    e = rks.Reference(mol, 1, "cpu").energy("B3LYP")
    assert abs(res.e_tot - e) < 1e-8


def _slow_mode_pair(seed=0, n=6, ratio=0.95, eps=1e-3):
    """(f1, f2, dm): CDIIS errors of f2 nearly ratio x those of f1 (s = x =
    1, err(f) = f D - D f), a slowly converging mode whose extrapolation
    takes coefficients near (-19, 20)."""
    rng = np.random.default_rng(seed)

    def sym():
        a = rng.standard_normal((n, n))
        return torch.tensor(a + a.T)

    f1, g, dm = sym(), sym(), sym()
    return f1, ratio * f1 + eps * g, dm


@pytest.mark.parametrize("bound", [None, 1e3])
def test_diis_bound_is_the_states(bound):
    from quantum_compute_dft_tpu_torch.scf import diis

    f1, f2, dm = _slow_mode_pair()
    eye = torch.eye(f1.shape[0], dtype=torch.float64)
    kw = {} if bound is None else {"max_coef_sum": bound}
    st = diis.diis_init(f1.shape[0], **kw)
    st, _ = diis.diis_update(st, f1, dm, eye, eye)
    st, f_ext = diis.diis_update(st, f2, dm, eye, eye)
    assert st.nsaved == 2
    assert st.max_coef_sum == (diis.MAX_COEF_SUM if bound is None else bound)
    if bound is None:    # sum |c| ~ 39 > 20: the newest Fock matrix
        assert torch.equal(f_ext, f2)
    else:                # the extrapolation, c1 f1 + c2 f2 with c1 + c2 = 1
        c2 = torch.linalg.lstsq((f_ext - f1).reshape(-1, 1),
                                (f2 - f1).reshape(-1, 1)).solution.item()
        assert abs(1.0 / c2) > 15.0


def test_only_the_verify_takes_the_verify_bound(monkeypatch):
    """Every DIIS history of a stalled H2S run is the kernel phase's (the
    default bound) but the one the handover opens."""
    made = []
    init = driver.diis_init

    def recording(*a, **k):
        st = init(*a, **k)
        made.append(st.max_coef_sum)
        return st

    monkeypatch.setattr(driver, "diis_init", recording)
    monkeypatch.setattr(driver, "VERIFY_MAX_COEF_SUM", 123.0)
    res = _run(H2S, "fast", *BELOW_FLOOR)
    assert res.converged and res.handover == "stall"
    assert made.count(123.0) == 1 and made[0] != 123.0


def test_verify_runs_without_the_level_shift(monkeypatch):
    """The shift controller is fed the kernel phase's cycles but the one
    that hands over, and no verify cycle; every verify cycle runs
    unshifted."""
    fed, shifts = [], []
    update = driver._ShiftController.update
    iteration = driver.scf_iteration

    def counting(self, cycle, dnorm):
        fed.append(cycle)
        return update(self, cycle, dnorm)

    def recording(*a, **k):
        shifts.append(k["shift"])
        return iteration(*a, **k)

    monkeypatch.setattr(driver._ShiftController, "update", counting)
    monkeypatch.setattr(driver, "scf_iteration", recording)
    res = _run(H2S, "fast", *BELOW_FLOOR)
    assert res.converged and res.handover == "stall"
    assert fed == list(range(res.fast_cycles - 1))
    assert shifts == [0.0] * res.verify_cycles
