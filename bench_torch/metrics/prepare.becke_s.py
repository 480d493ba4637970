"""Seconds of prepare in the Becke partition (span grid.becke, its copy to
the host included), mean over the window's jobs:
KSSetup.setup_split["becke_s"].  None where the program has no such span."""


def read(run):
    return run.mean("becke_s")
