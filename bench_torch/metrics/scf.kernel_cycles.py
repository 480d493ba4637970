"""Cycles of the fast schedule's kernel phase (XC on the fused f32
kernel), mean over the window's jobs: SCFResult.fast_cycles."""


def read(run):
    return run.mean("fast_cycles")
