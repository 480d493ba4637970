"""Seconds of the Cholesky factorization on the card (the diagonal and the
quartet panels, each to the end of its transfer to the host), mean over
the window's jobs: KSSetup.setup_split["cholesky_card_s"]."""


def read(run):
    return run.mean("cholesky_card_s")
