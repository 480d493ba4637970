"""Seconds of prepare in the setup cache's stores (each artifact's copy to
the host and its file), mean over the window's jobs:
KSSetup.setup_split["cache_store_s"]."""


def read(run):
    return run.mean("cache_store_s")
