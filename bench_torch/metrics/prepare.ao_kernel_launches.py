"""Launches of the AO-plane kernel K5 (csrc/ao_eval.cu) a job, mean over
the window's jobs: KSSetup.setup_split["ao_kernel_launches"] (one a job on
the card, the AO planes of the whole grid).  None where the program has no
such count."""


def read(run):
    return run.mean("ao_kernel_launches")
