"""utils/profiling.py on the CPU: PhaseTimer's fenced phases and report,
trace's Chrome trace file, and busy_seconds (no device events on the CPU,
so no device time; on the card chip_smoke.py phase 4f reads it)."""

import json

import torch

from quantum_compute_dft_tpu_torch.utils.profiling import (
    PhaseTimer,
    busy_seconds,
    trace,
)

torch.set_num_threads(1)


def test_phase_timer_and_trace(tmp_path):
    timer = PhaseTimer()
    a = torch.ones(64, 64, dtype=torch.float64)
    with trace(str(tmp_path)) as prof:
        for _ in range(3):
            with timer.phase("matmul", device="cpu"):
                a = a @ a / 64.0
    assert len(timer.times["matmul"]) == 3
    assert timer.avg_ms("matmul") > 0.0 and timer.avg_ms("none") == 0.0
    assert "matmul" in timer.report() and "over 3 calls" in timer.report()
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert any(n and "mm" in n for n in names)
    assert busy_seconds(prof) == 0.0
