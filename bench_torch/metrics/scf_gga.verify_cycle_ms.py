"""Mean wall ms of the hybrid SCF's f64 verify cycles (the f64 GGA XC and
the f64 K): the host clock from one cycle's callback to the next in
untraced reruns of the kept B3LYP job's SCF (gga_trace.py)."""

from bench_torch import gga_trace


def read(run):
    return gga_trace.read(run, "verify_cycle_ms")
