"""K2's share of its roofline: the least time of one fused XC call of the
LDA body (roofline.xc_bound_ms at the job's nao and grid points) over the
device time of the public entry fused_xc.fused_xc as torch.profiler's
trace reads it (25 calls), on the traced LDA job's packed planes and
converged density."""

from bench_torch.xc_timing import lda_roofline_pct


def read(run):
    return lda_roofline_pct(run)
