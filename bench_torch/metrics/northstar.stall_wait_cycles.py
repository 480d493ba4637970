"""Kernel-phase cycles after the one with the lowest ||dD||, up to the
handover, on the traced round's kept B3LYP job: SCFResult.stall_wait_cycles
(None where the program does not count them)."""


def read(run):
    kept = [res for setup, res in run.kept.values()
            if setup.functional.needs_grad]
    if not kept:
        return None
    return getattr(kept[-1], "stall_wait_cycles", None)
