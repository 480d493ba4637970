"""K1's share of its roofline: the least time of one fused XC call of the
GGA body (roofline.xc_bound_ms at the job's nao and grid points) over the
device time of the public entry fused_xc.fused_xc as torch.profiler's
trace reads it (25 calls), on the traced B3LYP job's packed planes and
converged density."""

from bench_torch.gga_xc_timing import gga_roofline_pct


def read(run):
    return gga_roofline_pct(run)
