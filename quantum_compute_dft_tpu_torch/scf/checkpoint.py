"""SCF checkpoint / resume.

Port of ``quantum_compute_dft_tpu/scf/checkpoint.py`` (numpy, copied): the
converged (or in-progress) density matrix plus metadata round-trips
through a plain .npz file; ``scf_host(dm0=...)`` resumes from it.

``periodic_saver`` builds the ``checkpoint_cb`` that ``scf_host`` calls
every ``checkpoint_every`` cycles, so a crash deep into a long run resumes
from the last periodic save instead of the initial guess.  Saves are
atomic (tmp file + os.replace): a crash mid-write can never corrupt the
previous good checkpoint.  A density on the card is copied to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save_checkpoint(path: str, dm, e_tot: float, cycle: int,
                    functional: str, molecule: str = "") -> None:
    if isinstance(dm, torch.Tensor):
        dm = dm.detach().cpu().numpy()
    # atomic: numpy appends .npz to bare paths, so write through an
    # explicit file handle at a tmp name and rename over the target
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(
            fh,
            dm=np.asarray(dm),
            e_tot=float(e_tot),
            cycle=int(cycle),
            functional=functional,
            molecule=molecule,
        )
    os.replace(tmp, str(path))


def periodic_saver(path: str, functional: str, molecule: str = ""):
    """-> checkpoint_cb(cycle, dm, e_tot) for scf_host: saves the
    in-progress density atomically at `path` (same format resume reads)."""

    def cb(cycle: int, dm, e_tot: float) -> None:
        save_checkpoint(path, dm, e_tot, cycle, functional, molecule)

    return cb


def load_checkpoint(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {
            "dm": f["dm"],
            "e_tot": float(f["e_tot"]),
            "cycle": int(f["cycle"]),
            "functional": str(f["functional"]),
            "molecule": str(f["molecule"]),
        }
