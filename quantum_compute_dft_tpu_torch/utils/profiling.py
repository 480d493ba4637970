"""Timing / profiling helpers.

Port of ``quantum_compute_dft_tpu/utils/profiling.py``.  The reference
hand-rolls wall-clock timing around its GPU calls with explicit stream
synchronization (ref dft.py:205-208, 245-261); here a phase is fenced by
``torch.cuda.synchronize`` on the card (nothing on the CPU, whose torch ops
have finished when they return), and ``trace`` writes a ``torch.profiler``
Chrome trace.  ``busy_seconds`` reads the device's busy time from a
profile: the union of its kernel and copy spans.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulates fenced wall-clock per named phase (the 'xc_times' list
    of ref dft.py:195,208 generalized)."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, device=None):
        """Time the block; with `device`, its queued work is waited for
        before the clock stops."""
        t0 = time.time()
        yield
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        self.times[name].append(time.time() - t0)

    def avg_ms(self, name: str) -> float:
        ts = self.times.get(name)
        return sum(ts) / len(ts) * 1000.0 if ts else 0.0

    def report(self) -> str:
        lines = ["Kernel statistics (avg per call):"]
        for name, ts in self.times.items():
            lines.append(
                f"  {name}: {sum(ts)/len(ts)*1000.0:.4f} ms over {len(ts)} calls"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU and, where there is one, the
    card); writes log_dir/trace.json (chrome://tracing) and yields the
    profile."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def busy_seconds(prof) -> float:
    """Device busy time of a profile: the union of the spans of its device
    events (kernels, copies), so overlapping spans count once."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e6
