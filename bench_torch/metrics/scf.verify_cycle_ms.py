"""Mean wall ms of the SCF's f64 verify cycles: the host clock from one
cycle's callback to the next in untraced reruns of the kept LDA job's SCF
(scf_trace.py)."""

from bench_torch import scf_trace


def read(run):
    return scf_trace.read(run, "verify_cycle_ms")
