"""Launches of the ERI quartet kernel K4 (csrc/eri_quartet.cu) a job, mean
over the window's jobs: KSSetup.setup_split["eri_kernel_launches"] (the
Cholesky's diagonal and panels, or the in-core diagonal and W).  None
where the program has no such count, or the quartet stage did not run."""


def read(run):
    return run.mean("eri_kernel_launches")
