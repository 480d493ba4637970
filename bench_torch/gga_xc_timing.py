"""K1's share of its roofline on a kept GGA-body job's own inputs: the
reader of xc_gga.roofline_pct, beside xc_timing.lda_roofline_pct (K2's)."""

from __future__ import annotations

from bench_torch.roofline import xc_bound_ms
from bench_torch.xc_timing import traced_ms


def gga_roofline_pct(run):
    """100 x least time / traced device time of fused_xc.fused_xc on the
    last kept job with a gradient term (PBE, B3LYP: K1), at its converged
    density; None without such a job, without a card or without device
    spans in the trace."""
    if run.device != "cuda":
        return None
    from quantum_compute_dft_tpu_torch.engine import fused_xc

    kept = [(s, r) for s, r in run.kept.values() if s.functional.needs_grad]
    if not kept:
        return None
    setup, res = kept[-1]
    s, fn = setup.sys, setup.functional
    aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                          needs_grad=True)
    dm = res.dm
    ms = traced_ms(lambda: fused_xc.fused_xc(fn, dm, aot, wt, grads,
                                             setup.nao))
    if ms is None:
        return None
    return 100.0 * xc_bound_ms(True, setup.nao, setup.ngrid) / ms
