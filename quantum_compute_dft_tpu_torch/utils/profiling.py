"""Timing / profiling helpers.

Port of ``quantum_compute_dft_tpu/utils/profiling.py``, with the port's own
spans.  ``span`` marks a piece of the program by name; it records nothing
unless ``recording()`` is on, so a job pays one module-level check per
span.  Under ``recording()`` a span is a ``torch.profiler.record_function``
range: a host event on the profiler's clock, beside the kernels and copies
it launched (the launch's correlation id ties a kernel to the runtime call,
and the call's time to the innermost span around it).  Given a dict
``into``, a span also adds its host seconds to it, on or off: the always-on
totals of ``kohn_sham.prepare``'s ``setup_split``.

``trace`` writes a ``torch.profiler`` Chrome trace, and ``busy_seconds``
reads the device's busy time from a profile: the union of its kernel and
copy spans.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_RECORDING = False
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """Spans on for the block (a profiler, entered by the caller, records
    them)."""
    global _RECORDING
    was, _RECORDING = _RECORDING, True
    try:
        yield
    finally:
        _RECORDING = was


class _Clock:
    """Adds the block's host seconds to into[key]."""

    __slots__ = ("into", "key", "t0")

    def __init__(self, into: dict, key: str):
        self.into, self.key = into, key

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        self.into[self.key] = (self.into.get(self.key, 0.0)
                               + time.perf_counter() - self.t0)


class _Span:
    """A record_function range, and the clock when there is a dict."""

    __slots__ = ("rf", "clock")

    def __init__(self, name: str, clock):
        self.rf = torch.profiler.record_function(name)
        self.clock = clock

    def __enter__(self):
        if self.clock is not None:
            self.clock.__enter__()
        self.rf.__enter__()

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if self.clock is not None:
            self.clock.__exit__(*exc)


def span(name: str, into: dict | None = None, key: str | None = None):
    """Context of one named piece of the program.  Off: the shared null
    context, or with `into` only the clock adding the block's host seconds
    to into[key or name].  Under recording(): also a record_function range
    named `name`."""
    clock = None if into is None else _Clock(into, key or name)
    if not _RECORDING:
        return _NULL if clock is None else clock
    return _Span(name, clock)


def spanned(name: str):
    """Decorator: the whole call is span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*a, **k):
            with span(name):
                return fn(*a, **k)
        return inner
    return wrap


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
    events (kernels, copies), so overlapping spans count once.  The
    device-side ranges that record_function adds for each span are not
    device work and are left out."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy_us += e - max(s, end)
            end = e
    return busy_us / 1e6
