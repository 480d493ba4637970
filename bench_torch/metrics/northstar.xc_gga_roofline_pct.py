"""K1's share of its roofline on the north star: roofline.xc_bound_ms at the
job's nao and grid points over the traced device time of one fused XC call
of the GGA body (25 calls), on the traced B3LYP job's packed planes and
converged density (gga_xc_timing.py, as xc_gga.roofline_pct)."""

from bench_torch.gga_xc_timing import gga_roofline_pct


def read(run):
    return gga_roofline_pct(run)
