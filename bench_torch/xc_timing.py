"""Reads the fused XC kernel's device time from a profiler trace, on a kept
job's own inputs, for the readers of its roofline share."""

from __future__ import annotations

from bench_torch.roofline import union_seconds, xc_bound_ms


def traced_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Device ms of one call of fn: the union of the device's kernel, copy
    and set spans in a torch.profiler trace of `reps` calls, over reps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    busy_ns = union_seconds(spans)
    return busy_ns * 1e-6 / reps if busy_ns > 0.0 else None


def lda_roofline_pct(run):
    """100 x least time / traced device time of fused_xc.fused_xc on the
    last kept LDA job (no gradient term); None without such a job, without
    a card or without device spans in the trace."""
    if run.device != "cuda":
        return None
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    kept = [(s, r) for s, r in run.kept.values()
            if not s.functional.needs_grad]
    if not kept:
        return None
    setup, res = kept[-1]
    s, fn = setup.sys, setup.functional
    aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                          needs_grad=False)
    dm = res.dm
    ms = traced_ms(lambda: fused_xc.fused_xc(fn, dm, aot, wt, grads,
                                             setup.nao))
    if ms is None:
        return None
    return 100.0 * xc_bound_ms(False, setup.nao, setup.ngrid) / ms
