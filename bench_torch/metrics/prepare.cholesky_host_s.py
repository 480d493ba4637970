"""Seconds of the Cholesky factorization on the host (the downdates, the
in-panel factorizations, the unpack and its upload), mean over the
window's jobs: KSSetup.setup_split["cholesky_host_s"]."""


def read(run):
    return run.mean("cholesky_host_s")
