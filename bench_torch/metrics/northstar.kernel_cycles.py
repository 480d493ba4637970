"""Cycles of the north star's kernel phase (XC on K1, the f32 aux-major K),
mean over the window's jobs: SCFResult.fast_cycles."""


def read(run):
    return run.mean("fast_cycles")
