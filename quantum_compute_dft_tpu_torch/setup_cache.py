"""Disk cache for per-molecule setup artifacts.

Port of ``quantum_compute_dft_tpu/setup_cache.py``.  S/T/V, the
pivoted-Cholesky ERI vectors, small in-core ERI tensors and the molecular
grid are pure functions of (geometry, basis tables, tolerances), and setup
dominates the time to solution on the card (the DHA Cholesky is seconds
against well under a second of SCF), so a warm run of the same molecule
loads them instead of rebuilding them.

Keyed, as in the JAX package, by a sha256 over the exact float64 geometry
bytes, the charges and the five basis tables (so edited basis data
invalidates).  Arrays are stored as host numpy, one file per (kind, key)
holding the names and then each array in .npy format (read straight into
memory, where an .npz's zip layer copies and checksums every byte), and
loaded onto the caller's device.  Each load and store is a span (utils/profiling.py),
``cache.load`` / ``cache.store``, whose seconds a caller may total in a
dict of its own (``into``).  Disable with DFT_SETUP_CACHE=0; the directory is
DFT_SETUP_CACHE_DIR, by default <repo>/.cache/setup_torch -- apart from the
JAX package's .cache/setup, so a port run never loads an artifact the JAX
package wrote.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np

from quantum_compute_dft_tpu_torch.utils.profiling import span


def _cache_dir() -> str | None:
    if os.environ.get("DFT_SETUP_CACHE", "1") == "0":
        return None
    d = os.environ.get("DFT_SETUP_CACHE_DIR")
    if not d:
        d = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            ".cache", "setup_torch",
        )
    os.makedirs(d, exist_ok=True)
    return d


def molecule_basis_key(mol, basis) -> str:
    """Hash of everything the integral artifacts depend on."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mol.coords, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(mol.charges, dtype=np.float64).tobytes())
    # basis tables content (catches canonical-data imports / edits)
    for arr in (basis.cart_powers, basis.cart_alphas, basis.cart_coeffs,
                basis.cart_centers, basis.c2s):
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:24]


def load(kind: str, key: str, names: tuple[str, ...],
         into: dict | None = None):
    """-> tuple of numpy arrays, or None on a miss (no file, or one that
    does not read).  With `into`, its seconds add to into["cache_load_s"]."""
    with span("cache.load", into, "cache_load_s"):
        d = _cache_dir()
        if d is None:
            return None
        path = os.path.join(d, f"{kind}_{key}.npy")
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                stored = [str(n) for n in np.load(f)]
                got = {n: np.load(f) for n in stored}
            return tuple(got[n] for n in names)
        except (OSError, ValueError, KeyError, EOFError):
            return None


def store(kind: str, key: str, into: dict | None = None, **arrays) -> None:
    """Write the arrays (numpy, or torch tensors, copied to the host here)
    under (kind, key).  The file is written under a name of its own and
    renamed into place, so concurrent writers of one key never leave a
    partial file.  With `into`, its seconds add to into["cache_store_s"]."""
    with span("cache.store", into, "cache_store_s"):
        d = _cache_dir()
        if d is None:
            return
        arrays = {n: a.cpu().numpy() if hasattr(a, "cpu") else a
                  for n, a in arrays.items()}
        path = os.path.join(d, f"{kind}_{key}.npy")
        fd, tmp = tempfile.mkstemp(suffix=".npy", dir=d)
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, np.array(list(arrays)))
                for a in arrays.values():
                    np.save(f, np.ascontiguousarray(a))
            os.replace(tmp, path)
        except OSError:   # a full or read-only disk costs the cache
            if os.path.exists(tmp):
                os.remove(tmp)
