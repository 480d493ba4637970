"""Seconds of prepare in the two-electron stage (in-core ERIs or the
Cholesky factor, or their load from the setup cache), mean over the
window's jobs: KSSetup.setup_split["two_electron_s"]."""


def read(run):
    return run.mean("two_electron_s")
