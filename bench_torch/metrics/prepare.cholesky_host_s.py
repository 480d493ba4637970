"""Seconds of the Cholesky factorization (the downdates, the in-panel
factorizations and the unpack), on the factor's device (the card) and
paced by the host's pivot loop, one sync a column; the name is older than
the move to the card.  Mean over the window's jobs:
KSSetup.setup_split["cholesky_host_s"]."""


def read(run):
    return run.mean("cholesky_host_s")
