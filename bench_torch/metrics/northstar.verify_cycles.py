"""The north star's f64 verify cycles after its kernel phase, mean over the
window's jobs: SCFResult.verify_cycles."""


def read(run):
    return run.mean("verify_cycles")
