"""Kernel launches per SCF cycle: the runtime calls that launch a kernel
inside the scf.cycle spans of one traced rerun of the kept LDA job's SCF,
over its cycles (scf_trace.py); on the card only."""

from bench_torch import scf_trace


def read(run):
    return scf_trace.read(run, "launches_per_cycle")
