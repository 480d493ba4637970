"""Mean wall ms of the hybrid SCF's kernel-phase cycles (XC on K1, the f32
aux-major K), the first left out: the host clock from one cycle's
callback to the next in untraced reruns of the kept B3LYP job's SCF
(gga_trace.py)."""

from bench_torch import gga_trace


def read(run):
    return gga_trace.read(run, "kernel_cycle_ms")
