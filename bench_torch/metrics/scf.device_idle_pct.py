"""Share of the SCF's wall in which no operation ran on the card, over
the traced round's calls into scf_host under torch.profiler:
100 (1 - busy / wall), busy the union of the device's spans."""


def read(run):
    prof = run.profile
    if not prof or prof["scf_s"] <= 0.0 or prof["scf_busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - prof["scf_busy_s"] / prof["scf_s"])
