"""Seconds of prepare in the grid and the AO planes, mean over the
window's jobs: KSSetup.setup_split grid_s + ao_s."""


def read(run):
    vals = [j["grid_s"] + j["ao_s"] for j in run.jobs
            if j.get("grid_s") is not None and j.get("ao_s") is not None]
    return sum(vals) / len(vals) if vals else None
