"""utils/profiling.py and the spans it puts in the port, on the CPU (H2O):
span and recording (off: nothing in a profile, the always-on totals
filled; on: the SCF's cycles and prepare's stages as nested ranges, the
energies bitwise unchanged), trace's Chrome trace file, busy_seconds (no
device events on the CPU; on a made-up profile, the device-side ranges of
spans left out), the Cholesky's split between card and host, and the
benchmark's readers of the spans (bench_torch/scf_trace.py) on the CPU
rehearsal and on a made-up device trace, and the per-span table of one
whole cold job that tools/profile_torch_scf.py prints."""

import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.integrals.cholesky import (
    cholesky_eri_vectors,
)
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.driver import scf_host
from quantum_compute_dft_tpu_torch.utils import profiling
from quantum_compute_dft_tpu_torch.utils.profiling import (
    busy_seconds,
    recording,
    span,
    trace,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import harness, scf_trace  # noqa: E402

H2O = os.path.join(ROOT, "molecules", "H2O.xyz")
STAGES = ("prepare.one_electron", "prepare.two_electron", "prepare.grid",
          "prepare.ao", "prepare.system")

torch.set_num_threads(1)


def _spans(prof):
    """(start, end, name) of the profile's host-side span ranges."""
    return [(e.start_ns(), e.end_ns(), e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.is_user_annotation()]


def _inside(outer, spans, name):
    return [s for s in spans if s[2] == name
            and outer[0] <= s[0] and s[1] <= outer[1]]


def _job(tmp_path, monkeypatch):
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path / "cache"))
    setup = kohn_sham.prepare(from_xyz_file(H2O), "LDA", grid_level=1,
                              device="cpu")
    return setup, scf_host(setup.sys, setup.functional, xc_impl="fast")


def test_phase_timer_and_trace(tmp_path, monkeypatch):
    """Off: no span in the trace, setup_split's totals filled; on: one
    scf.cycle range per cycle, each holding XC, J, eigh and the fetch,
    prepare's five stages inside prepare and the Becke partition inside its
    grid stage."""
    with trace(str(tmp_path / "off")) as prof:
        setup, res = _job(tmp_path / "a", monkeypatch)
    names = {n for _, _, n in _spans(prof)}
    assert not {n for n in names if n.startswith(("scf", "prepare"))}
    split = setup.setup_split
    assert split["cache_store_s"] > 0.0 and split["cache_load_s"] >= 0.0
    assert list(split)[:5] == ["one_electron_s", "two_electron_s", "grid_s",
                               "ao_s", "system_s"]
    assert busy_seconds(prof) == 0.0

    with trace(str(tmp_path / "on")) as prof, recording():
        setup, res = _job(tmp_path / "b", monkeypatch)
    spans = _spans(prof)
    cycles = [s for s in spans if s[2] == "scf.cycle"]
    assert len(cycles) == res.n_iter
    for c in cycles:
        for piece in ("scf.xc", "scf.j", "scf.eigh", "scf.fetch"):
            assert len(_inside(c, spans, piece)) == 1, piece
    (prep,) = [s for s in spans if s[2] == "prepare"]
    for stage in STAGES:
        assert len(_inside(prep, spans, stage)) == 1, stage
    (grid,) = _inside(prep, spans, "prepare.grid")
    assert len(_inside(grid, spans, "grid.becke")) == 1
    (scf,) = [s for s in spans if s[2] == "scf"]
    assert len(_inside(scf, spans, "scf.cycle")) == res.n_iter
    assert len(_inside(scf, spans, "scf.energy_of_dm")) == 1
    with open(tmp_path / "on" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "scf.cycle" in names and any(n and "mm" in n for n in names)
    assert not profiling._RECORDING


def test_span_off_is_shared_null_and_into_adds_seconds():
    assert span("a") is span("b")
    into = {}
    for on in (False, True):
        with (recording() if on else span("outside")):
            with span("x", into, "x_s"):
                time.sleep(0.01)
            with span("x", into):
                pass
    assert into["x_s"] >= 0.02 and into["x"] >= 0.0
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        with span("outer"):
            with span("inner", into):
                pass
    names = [n for _, _, n in _spans(prof)]
    assert names.count("outer") == 1 and names.count("inner") == 1


def test_recording_leaves_energies_bitwise(tmp_path, monkeypatch):
    setup, off = _job(tmp_path, monkeypatch)
    with recording():
        on = scf_host(setup.sys, setup.functional, xc_impl="fast")
    assert on.e_tot == off.e_tot
    assert (on.fast_cycles, on.verify_cycles) == (off.fast_cycles,
                                                  off.verify_cycles)
    assert torch.equal(on.dm, off.dm)


def _ev(name, start, end, device=DeviceType.CPU, annotation=False, corr=0):
    """The methods of a raw kineto event that scf_trace reads."""
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
        device_type=lambda: device, is_user_annotation=lambda: annotation,
        correlation_id=lambda: corr)


def test_busy_seconds_leaves_out_annotations():
    def fe(start_us, end_us, device=DeviceType.CUDA, annotation=False):
        """The fields of a FunctionEvent that busy_seconds reads."""
        return SimpleNamespace(
            device_type=device, is_user_annotation=annotation,
            time_range=SimpleNamespace(start=start_us, end=end_us))

    events = [fe(0, 2000), fe(1000, 3000), fe(0, 9000, annotation=True),
              fe(0, 9000, DeviceType.CPU, True), fe(0, 9000, DeviceType.CPU)]
    prof = SimpleNamespace(events=lambda: events)
    assert busy_seconds(prof) == pytest.approx(3e-3)


def test_scf_trace_attributes_launches_waits_and_idle():
    """A made-up device trace of two cycles: launches and waits inside the
    cycle spans, kernels tied to the innermost span of their launch by
    correlation id, idle gaps put down to the span at their middle."""
    cuda, ms = DeviceType.CUDA, 1_000_000
    ann = dict(annotation=True)
    events = [
        _ev("scf", 0, 100 * ms, **ann),
        _ev("scf.cycle", 0, 40 * ms, **ann),
        _ev("scf.xc", 1 * ms, 20 * ms, **ann),
        _ev("scf.fetch", 30 * ms, 39 * ms, **ann),
        _ev("scf.cycle", 40 * ms, 90 * ms, **ann),
        _ev("scf.j", 41 * ms, 50 * ms, **ann),
        _ev("scf.energy_of_dm", 91 * ms, 99 * ms, **ann),
        _ev("cudaLaunchKernel", 2 * ms, 3 * ms, corr=1),
        _ev("cuLaunchKernel", 42 * ms, 43 * ms, corr=2),
        _ev("aten::mm", 42 * ms, 44 * ms),
        _ev("cudaLaunchKernel", 92 * ms, 93 * ms, corr=3),
        _ev("cudaMemcpyAsync", 31 * ms, 32 * ms, corr=4),
        _ev("cudaStreamSynchronize", 32 * ms, 38 * ms, corr=5),
        _ev("cudaMemcpy", 60 * ms, 61 * ms, corr=6),
        _ev("kernel_a", 3 * ms, 13 * ms, cuda, corr=1),
        _ev("kernel_b", 43 * ms, 48 * ms, cuda, corr=2),
        _ev("kernel_c", 93 * ms, 95 * ms, cuda, corr=3),
        _ev("Memcpy DtoH (Device -> Pageable)", 32 * ms, 33 * ms, cuda,
            corr=4),
        _ev("Memcpy DtoH (Device -> Pageable)", 60 * ms, 61 * ms, cuda,
            corr=6),
        _ev("scf.xc", 1 * ms, 20 * ms, cuda, True),
    ]
    out = scf_trace.summarize(events, 1, True)
    assert out["cycles"] == 2 and out["kernel_cycles"] == 1
    assert out["traced_kernel_cycle_ms"] == pytest.approx(40.0)
    assert out["traced_verify_cycle_ms"] == pytest.approx(50.0)
    assert out["covered"] == pytest.approx(0.98)
    assert out["launches_per_cycle"] == pytest.approx(1.0)
    assert out["syncs_per_cycle"] == pytest.approx(1.0)   # sync + memcpy
    spans = out["spans"]
    assert spans["scf.xc"]["device_ms"] == pytest.approx(10.0)
    assert spans["scf.j"]["device_ms"] == pytest.approx(5.0)
    assert spans["scf.fetch"]["device_ms"] == pytest.approx(1.0)
    assert spans["scf.cycle"]["device_ms"] == pytest.approx(1.0)
    assert spans["scf.energy_of_dm"]["launches"] == 1
    # idle: 100 ms less 10 + 1 + 5 + 1 + 2 ms of device work
    assert out["idle_pct"] == pytest.approx(81.0)
    idle = out["idle_ms_by_span"]
    assert idle["scf.fetch"] == pytest.approx(10.0)   # 33-43, middle 38
    assert idle["scf.cycle"] == pytest.approx(19.0 + 12.0 + 32.0)
    assert sum(idle.values()) == pytest.approx(81.0)
    assert out["device_ms_untied"] == 0.0
    assert scf_trace.summarize(events, 1, False)["syncs_per_cycle"] is None


def test_scf_trace_cycle_ms_from_callback_marks():
    """Cycle walls from the clock marks at each cycle's callback: the first
    kernel-phase cycle has no mark before it and is left out."""
    marks = [1.0, 1.004, 1.010, 1.030, 1.050]
    kernel, verify = scf_trace.cycle_ms(marks, 3)
    assert kernel == pytest.approx(5.0) and verify == pytest.approx(20.0)
    assert scf_trace.cycle_ms(marks, 1) == (None, pytest.approx(12.5))
    assert scf_trace.cycle_ms(marks[:3], 3) == (pytest.approx(5.0), None)


def test_span_table_reads_a_whole_cold_job(tmp_path, monkeypatch):
    """tools/profile_torch_scf.py's table of one cold CLI job (H2O, the
    Cholesky): every span of the job, prepare, the cache, the Cholesky and
    the SCF has a row; on the CPU no device numbers."""
    from quantum_compute_dft_tpu_torch import cli

    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path / "cache"))
    argv = ["LDA", "H2O", "--grid-level", "1", "--device", "cpu",
            "--density-fit", "on", "--molecules-dir",
            os.path.join(ROOT, "molecules")]
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording():
        cli.run(argv)
    table, loose, untied = scf_trace.span_table(
        *scf_trace.parse(prof.profiler.kineto_results.events()), False)
    want = ("job", "prepare", *STAGES, "cache.load", "cache.store",
            "cholesky.diag", "cholesky.panel", "cholesky.factor",
            "cholesky.unpack", "scf", "scf.cycle", "scf.xc", "scf.j",
            "scf.mix", "scf.eigh", "scf.sanity", "scf.fetch",
            "scf.energy_of_dm", "job.xc_statistic")
    for name in want:
        assert table[name]["host_ms"] > 0.0, name
        assert table[name]["device_ms"] is None, name
    assert list(table)[0] == "job" and loose is None and untied is None
    assert (table["job"]["host_ms"] > table["prepare"]["host_ms"]
            + table["scf"]["host_ms"] + table["job.xc_statistic"]["host_ms"])


def test_cholesky_timings_split(monkeypatch):
    basis = build_basis(from_xyz_file(H2O))
    plain = cholesky_eri_vectors(basis, block=8)
    t = {}
    t0 = time.perf_counter()
    timed = cholesky_eri_vectors(basis, block=8, timings=t)
    wall = time.perf_counter() - t0
    assert torch.equal(plain, timed)
    assert t["cholesky_panels"] >= 2
    assert t["cholesky_card_s"] > 0.0 and t["cholesky_host_s"] > 0.0
    assert t["cholesky_card_s"] + t["cholesky_host_s"] <= wall
    with recording():
        assert torch.equal(cholesky_eri_vectors(basis, block=8), plain)


def test_prepare_merges_the_cholesky_split(tmp_path, monkeypatch):
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path))
    mol = from_xyz_file(H2O)
    cold = kohn_sham.prepare(mol, "LDA", grid_level=1, density_fit=True,
                             device="cpu").setup_split
    warm = kohn_sham.prepare(mol, "LDA", grid_level=1, density_fit=True,
                             device="cpu").setup_split
    assert cold["cholesky_panels"] >= 1
    assert (cold["cholesky_card_s"] + cold["cholesky_host_s"]
            <= cold["two_electron_s"])
    assert cold["cache_store_s"] > 0.0 and cold["cache_load_s"] >= 0.0
    assert "cholesky_card_s" not in warm and warm["cache_load_s"] > 0.0
    assert warm["cache_store_s"] == 0.0


def test_bench_readers_on_the_cpu_rehearsal(tmp_path, monkeypatch):
    """The rehearsal (H2O grid 1, here with the Cholesky) with --trace 1:
    the new program_span readers give numbers, the device_trace ones
    none."""
    conf = harness.load_json(os.path.join(ROOT, "bench_torch", "rehearsal",
                                          "h2o.sto3g.grid1.json"))
    conf["argv"] = conf["argv"] + ["--density-fit", "on"]
    path = tmp_path / "h2o_cd.json"
    path.write_text(json.dumps(conf))
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path / "cache"))
    res = harness.run("dha.lda.cold", seed=2**31 + 9, seconds=0.1,
                      trace=True, t_start=time.perf_counter(),
                      device="cpu", config_path=str(path))
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("prepare.cholesky_card_s", "prepare.cholesky_host_s",
                 "prepare.cache_store_s", "scf.kernel_cycle_ms",
                 "scf.verify_cycle_ms"):
        assert np.isfinite(got[name]) and got[name] > 0.0, name
    for name in ("scf.launches_per_cycle", "scf.syncs_per_cycle",
                 "scf.device_idle_pct", "xc_lda.roofline_pct"):
        assert name not in got, name
    assert got["prepare.ao_kernel_launches"] == 0.0  # the plain version
