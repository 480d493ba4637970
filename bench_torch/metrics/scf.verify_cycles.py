"""The fast schedule's f64 verify cycles, mean over the window's jobs:
SCFResult.verify_cycles."""


def read(run):
    return run.mean("verify_cycles")
