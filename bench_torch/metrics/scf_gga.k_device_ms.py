"""Device ms of the exact-exchange K over one hybrid SCF: the kernels
launched under the span scf.k in the traced rerun of the kept B3LYP job's
SCF (gga_trace.py), on the card only; None unless the rerun's
SCFResult.k_builds_fast equals its kernel-phase cycles."""

from bench_torch import gga_trace


def read(run):
    return gga_trace.read(run, "k_device_ms")
