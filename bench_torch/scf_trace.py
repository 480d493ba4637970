"""The SCF's own spans, read from reruns of a kept job's SCF.

The traced round keeps its jobs' setups and results (``Run.kept``).  Once
per run, ``trace`` reruns ``scf_host`` on the kept LDA job's system, on the
job's own schedule and convergence rule (the CLI's defaults, which the
configurations state): ``REPS`` times untraced, and once more with the
program's spans on (``utils/profiling.recording``) under
``torch.profiler``.  The reruns count only when their kernel-phase and
verify cycles are the kept job's, so they are of the same SCF.

* Cycle ms come from the untraced reruns, so that the profiler's cost per
  launch does not weigh on them: the host clock at ``scf_host``'s
  callback, which each cycle calls right after its synced fetch, less the
  clock at the cycle before.  The first ``fast_cycles`` cycles are the
  kernel phase (the first of them, which has no mark before it, is left
  out), the rest the f64 verify cycles.

From the traced rerun's raw kineto events:

* per cycle, the runtime calls inside the ``scf.cycle`` spans that launch a
  kernel, and those that make the host wait for the device (stream, device
  and event synchronizes, and synchronous copies to the host; an
  asynchronous copy to the host waits in the stream synchronize that
  follows it and counts there once);
* per program span, its host ms and the device ms and launches of the
  kernels it launched: a kernel is tied to its launch by correlation id,
  and the launch to the innermost span running at its start
  (``span_table``, which ``tools/profile_torch_scf.py`` also prints for a
  whole job);
* the SCF's longest device idle gaps, each put down to the innermost span
  running at its middle.

The device's numbers exist only on the card; on the CPU they are None.
A program without the spans (no ``recording``) gives None throughout.
"""

from __future__ import annotations

import bisect
import json
import re
import statistics
import sys
import weakref

# (weakref to the run, its summary): the readers of one run share a rerun
_MEMO = [None, None]
# untraced reruns that time the cycles; the median of their means is read
REPS = 3

# the CUDA runtime's and driver's calls (cudaLaunchKernel, cuLaunchKernel,
# cudaStreamSynchronize, ...): host events named so
RUNTIME = re.compile(r"cu(da)?[A-Z]")
# runtime calls that make the host wait for the device
SYNC_SUFFIX = "Synchronize"
SYNC_COPIES = ("cudaMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2")


def is_launch(name: str) -> bool:
    return "Launch" in name and "Kernel" in name


def innermost(spans):
    """Flattens nested (start, end, name) spans into non-overlapping
    segments labelled with the innermost span: -> (starts, segments)."""
    segs, stack, cur = [], [], None
    for s, e, n in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            segs.append((cur, top[1], top[2]))
            cur = top[1]
        if stack and cur < s:
            segs.append((cur, s, stack[-1][2]))
        cur = s
        stack.append((s, e, n))
    while stack:
        top = stack.pop()
        segs.append((cur, top[1], top[2]))
        cur = top[1]
    segs = [g for g in segs if g[1] > g[0]]
    return [g[0] for g in segs], segs


def label_at(index, t):
    """The innermost span running at time t, or None."""
    starts, segs = index
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else None


def parse(events):
    """Raw kineto events (ns) -> (the program's spans (start, end, name),
    the CUDA runtime calls and the device's work (start, end, name,
    correlation id); the device-side ranges of spans left out)."""
    from torch.autograd import DeviceType

    spans, runtime, device = [], [], []
    for e in events:
        rng = (e.start_ns(), e.end_ns(), e.name())
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(rng + (e.correlation_id(),))
        elif e.is_user_annotation():
            spans.append(rng)
        elif RUNTIME.match(rng[2]):
            runtime.append(rng + (e.correlation_id(),))
    return spans, runtime, device


def span_table(spans, runtime, device, on_device: bool):
    """Per span name, in the order the spans first start: its host ms
    (summed over its ranges) and, on the card, the device ms and count of
    the kernels and copies launched while it was the innermost span ->
    (the table, device ms launched outside every span, device ms whose
    launch the trace does not hold; both None off the card)."""
    table = {}
    for s, e, n in sorted(spans):
        row = table.setdefault(n, dict(host_ms=0.0, device_ms=None,
                                       launches=None))
        row["host_ms"] += (e - s) * 1e-6
    if not on_device:
        return table, None, None
    for row in table.values():
        row.update(device_ms=0.0, launches=0)
    index = innermost(spans)
    launch_at = {c: s for s, _, _, c in runtime}
    loose = untied = 0.0
    for s, e, n, c in device:
        if c not in launch_at:
            untied += (e - s) * 1e-6
            continue
        where = label_at(index, launch_at[c])
        if where is None:
            loose += (e - s) * 1e-6
            continue
        table[where]["device_ms"] += (e - s) * 1e-6
        table[where]["launches"] += 1
    return table, loose, untied


def summarize(events, n_kernel: int, on_device: bool) -> dict:
    """Reads a profile of one scf_host call with spans on (raw kineto
    events, ns) -> the summary (ms and counts; device numbers None unless
    on_device).  The cycle walls here are the traced ones
    (traced_*_cycle_ms), which the profiler inflates."""
    spans, runtime, device = parse(events)
    scf = [s for s in spans if s[2] == "scf"]
    cycles = sorted(s for s in spans if s[2] == "scf.cycle")
    if len(scf) != 1 or not cycles:
        return None
    lo, hi = scf[0][0], scf[0][1]
    walls = [(e - s) * 1e-6 for s, e, _ in cycles]
    kernel, verify = walls[:n_kernel], walls[n_kernel:]
    final = sum(e - s for s, e, n in spans if n == "scf.energy_of_dm")
    table, loose, untied = span_table(spans, runtime, device, on_device)
    out = dict(
        cycles=len(cycles), kernel_cycles=len(kernel),
        traced_kernel_cycle_ms=statistics.fmean(kernel) if kernel else None,
        traced_verify_cycle_ms=statistics.fmean(verify) if verify else None,
        scf_ms=(hi - lo) * 1e-6,
        covered=(sum(e - s for s, e, _ in cycles) + final) / (hi - lo),
        launches_per_cycle=None, syncs_per_cycle=None, spans=table,
        # device ms whose launch lies outside every span, and whose launch
        # the trace does not hold
        device_ms_outside_spans=loose, device_ms_untied=untied)
    if not on_device:
        return out
    from bench_torch import roofline

    cyc_index = innermost([(s, e, i) for i, (s, e, _) in enumerate(cycles)])
    dev_op = {c: n for _, _, n, c in device}
    launches = waits = 0
    for s, e, n, c in runtime:
        if label_at(cyc_index, s) is None:
            continue
        if is_launch(n):
            launches += 1
        elif n.endswith(SYNC_SUFFIX) or (
                n in SYNC_COPIES and "DtoH" in dev_op.get(c, "")):
            waits += 1
    out["launches_per_cycle"] = launches / len(cycles)
    out["syncs_per_cycle"] = waits / len(cycles)
    index = innermost(spans)
    idle = {}
    gaps = roofline.gaps([(s, e) for s, e, _, _ in device], lo, hi)
    for gs, ge in sorted(gaps, key=lambda g: g[0] - g[1])[:100]:
        where = label_at(index, 0.5 * (gs + ge)) or "(no span)"
        idle[where] = idle.get(where, 0.0) + (ge - gs) * 1e-6
    out["idle_ms_by_span"] = dict(sorted(idle.items(),
                                         key=lambda kv: -kv[1]))
    out["idle_pct"] = 100.0 * sum(ge - gs for gs, ge in gaps) / (hi - lo)
    return out


def cycle_ms(marks, n_kernel: int):
    """Host clock marks (s) at the end of each cycle of one SCF ->
    (mean ms of its kernel-phase cycles after the first, mean ms of its
    verify cycles); None where there are none."""
    walls = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    kernel, verify = walls[:n_kernel - 1], walls[n_kernel - 1:]
    return (statistics.fmean(kernel) if kernel else None,
            statistics.fmean(verify) if verify else None)


def _rerun(run):
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quantum_compute_dft_tpu_torch import cli
    from quantum_compute_dft_tpu_torch.scf import driver
    from quantum_compute_dft_tpu_torch.utils import profiling

    recording = getattr(profiling, "recording", None)
    kept = [(s, r) for s, r in run.kept.values()
            if not s.functional.needs_grad]
    if recording is None or not kept:
        return None
    setup, ref = kept[-1]
    parser = cli.build_parser()
    tol_e, tol_d = (parser.get_default(k) for k in ("conv_tol_e",
                                                    "conv_tol_d"))
    on_device = run.device == "cuda"

    def scf(callback=None):
        res = driver.scf_host(setup.sys, setup.functional, xc_impl="fast",
                              conv_tol_e=tol_e, conv_tol_d=tol_d,
                              callback=callback)
        if on_device:
            torch.cuda.synchronize()
        return res

    def same(res):
        return (res.fast_cycles, res.verify_cycles) == (ref.fast_cycles,
                                                       ref.verify_cycles)

    kernel_ms, verify_ms = [], []
    for _ in range(REPS):
        marks = []
        res = scf(lambda *_: marks.append(time.perf_counter()))
        if not same(res):
            return None
        k, v = cycle_ms(marks, res.fast_cycles)
        kernel_ms += [] if k is None else [k]
        verify_ms += [] if v is None else [v]
    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with recording():
            res = scf()
    print(f"scf_trace: rerun {res.fast_cycles} + {res.verify_cycles} "
          f"cycles, kept job's {ref.fast_cycles} + {ref.verify_cycles}; "
          f"energy bitwise the kept job's: {res.e_tot == ref.e_tot}",
          file=sys.stderr)
    if not same(res):
        return None
    out = summarize(prof.profiler.kineto_results.events(), res.fast_cycles,
                    on_device)
    if out is not None:
        out["kernel_cycle_ms"] = (statistics.median(kernel_ms)
                                  if kernel_ms else None)
        out["verify_cycle_ms"] = (statistics.median(verify_ms)
                                  if verify_ms else None)
        out["energy_bitwise"] = res.e_tot == ref.e_tot
        print("scf_trace: " + json.dumps(out), file=sys.stderr)
    return out


def trace(run):
    """The summary of the run's traced SCF rerun (once per run), or None;
    a rerun or a reading that raises prints why and gives None, so the
    other readers still read."""
    if _MEMO[0] is None or _MEMO[0]() is not run:
        try:
            out = _rerun(run)
        except Exception as e:  # noqa: BLE001
            print(f"scf_trace: no reading: {type(e).__name__}: {e}",
                  file=sys.stderr)
            out = None
        _MEMO[:] = [weakref.ref(run), out]
    return _MEMO[1]


def read(run, key: str):
    """One number of the summary, or None."""
    out = trace(run)
    return None if out is None else out.get(key)
