"""Launches of the Becke partition kernel K6 (csrc/becke.cu) a job, mean
over the window's jobs: KSSetup.setup_split["becke_kernel_launches"] (one a
job on the card when the grid is built, 0 when it is loaded).  None where
the program has no such count."""


def read(run):
    return run.mean("becke_kernel_launches")
