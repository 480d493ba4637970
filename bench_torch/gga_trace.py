"""The hybrid SCF's cycle walls and its exchange K's device time, read
from reruns of the kept B3LYP (GGA-body) job's SCF.

``scf_trace.py`` reads the kept LDA job; this module reads the kept job
whose functional has a gradient term, by the same rule and with the same
readers (``scf_trace.cycle_ms``, ``scf_trace.summarize``): ``REPS``
untraced reruns of ``scf_host`` on the job's own system, schedule and
convergence rule, and one more with the program's spans on under
``torch.profiler``; the reruns count only when their kernel-phase and
verify cycles are the kept job's.

* ``kernel_cycle_ms``, ``verify_cycle_ms``: the mean host ms of each
  phase's cycles, from one cycle's callback to the next, in the untraced
  reruns (the median of their means);
* ``k_device_ms``: the device ms of the kernels launched under the span
  ``scf.k`` (the exact-exchange K of every cycle) over the traced rerun's
  whole SCF, on the card only; None unless the rerun's
  ``SCFResult.k_builds_fast`` equals its kernel-phase cycles, so that the
  f32 aux-major K ran in each of them (a program without the count gives
  None).
"""

from __future__ import annotations

import json
import statistics
import sys
import weakref

from bench_torch import scf_trace

# (weakref to the run, its summary): the readers of one run share a rerun
_MEMO = [None, None]


def _rerun(run):
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from quantum_compute_dft_tpu_torch import cli
    from quantum_compute_dft_tpu_torch.scf import driver
    from quantum_compute_dft_tpu_torch.utils import profiling

    recording = getattr(profiling, "recording", None)
    kept = [(s, r) for s, r in run.kept.values() if s.functional.needs_grad]
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
    for _ in range(scf_trace.REPS):
        marks = []
        res = scf(lambda *_: marks.append(time.perf_counter()))
        if not same(res):
            return None
        k, v = scf_trace.cycle_ms(marks, res.fast_cycles)
        kernel_ms += [] if k is None else [k]
        verify_ms += [] if v is None else [v]
    acts = [ProfilerActivity.CPU]
    if on_device:
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with recording():
            res = scf()
    k_fast = getattr(res, "k_builds_fast", None)
    print(f"gga_trace: rerun {res.fast_cycles} + {res.verify_cycles} "
          f"cycles, kept job's {ref.fast_cycles} + {ref.verify_cycles}; "
          f"K builds f32 / f64: {k_fast} / "
          f"{getattr(res, 'k_builds_f64', None)}; energy bitwise the kept "
          f"job's: {res.e_tot == ref.e_tot}", file=sys.stderr)
    if not same(res):
        return None
    out = scf_trace.summarize(prof.profiler.kineto_results.events(),
                              res.fast_cycles, on_device)
    if out is None:
        return None
    out["kernel_cycle_ms"] = (statistics.median(kernel_ms)
                              if kernel_ms else None)
    out["verify_cycle_ms"] = (statistics.median(verify_ms)
                              if verify_ms else None)
    k_span = out["spans"].get("scf.k") or {}
    out["k_device_ms"] = (k_span.get("device_ms")
                          if k_fast == res.fast_cycles else None)
    out["k_builds_fast"] = k_fast
    out["energy_bitwise"] = res.e_tot == ref.e_tot
    print("gga_trace: " + json.dumps(out), file=sys.stderr)
    return out


def trace(run):
    """The summary of the run's GGA SCF rerun (once per run), or None; a
    rerun or a reading that raises prints why and gives None, so the other
    readers still read."""
    if _MEMO[0] is None or _MEMO[0]() is not run:
        try:
            out = _rerun(run)
        except Exception as e:  # noqa: BLE001
            print(f"gga_trace: no reading: {type(e).__name__}: {e}",
                  file=sys.stderr)
            out = None
        _MEMO[:] = [weakref.ref(run), out]
    return _MEMO[1]


def read(run, key: str):
    """One number of the summary, or None."""
    out = trace(run)
    return None if out is None else out.get(key)
