"""Mean wall ms of the SCF's kernel-phase cycles (XC on the fused f32
kernel), the first left out: the host clock from one cycle's callback to
the next in untraced reruns of the kept LDA job's SCF (scf_trace.py)."""

from bench_torch import scf_trace


def read(run):
    return scf_trace.read(run, "kernel_cycle_ms")
