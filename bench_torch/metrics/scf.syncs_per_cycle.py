"""Host waits for the device per SCF cycle: the stream, device and event
synchronizes and synchronous copies to the host inside the scf.cycle
spans of one traced rerun of the kept LDA job's SCF, over its cycles
(scf_trace.py); on the card only."""

from bench_torch import scf_trace


def read(run):
    return scf_trace.read(run, "syncs_per_cycle")
