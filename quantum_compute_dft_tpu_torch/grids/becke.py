"""Becke partition weights (Becke, JCP 88, 2547 (1988)) in torch f64.

Port of ``quantum_compute_dft_tpu/grids/becke.py``: O(ngrid * natm^2)
elementwise work, with the Appendix atomic-size adjustment from
Bragg-Slater radii.  ``becke_partition`` is the grid builder's entry: on a
CUDA device one launch of kernel K6 (``csrc/becke.cu``: one thread a
point, the whole grid in one launch, nothing of size (point, atom, atom) in
device memory) on the pair tables that ``k6_tables`` computes, counted in
``LAUNCHES``; the wrapper builds K6 at first use (nvcc, keyed by a hash of
the source, as ``engine/fused_xc.py`` builds K1-K3) and binds it with
ctypes.  On the CPU it runs the plain version, ``becke_weights_chunked``
(eager broadcast chunks of ``becke_weights``, which also run on the card,
for comparison).  No fallback: a CUDA device launches K6 or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.engine.fused_xc import (
    _on,
    _stream,
    build_library,
)


def _stepfun(mu: torch.Tensor) -> torch.Tensor:
    """Becke's thrice-iterated smoothing polynomial -> s(mu) in [0, 1]."""
    p = mu
    for _ in range(3):
        p = 0.5 * p * (3.0 - p * p)
    return 0.5 * (1.0 - p)


def _pair_tables(atom_xyz: torch.Tensor, radii: torch.Tensor):
    """-> (R_ij with 1 on the diagonal, the size adjustment a_ij), both
    (natm, natm)."""
    natm = atom_xyz.shape[0]
    eye = torch.eye(natm, dtype=torch.bool, device=atom_xyz.device)
    rab = torch.linalg.norm(atom_xyz[:, None, :] - atom_xyz[None, :, :],
                            dim=-1)
    rab = torch.where(eye, 1.0, rab)
    # size-adjustment parameter a_ij from Bragg radii (Becke appendix)
    chi = radii[:, None] / radii[None, :]
    u = (chi - 1.0) / (chi + 1.0)
    return rab, torch.clamp(u / (u * u - 1.0), -0.5, 0.5)


def becke_weights(
    coords: torch.Tensor,    # (ngrid, 3) grid points
    atom_xyz: torch.Tensor,  # (natm, 3)
    atom_idx: torch.Tensor,  # (ngrid,) owning atom of each point
    radii: torch.Tensor,     # (natm,) Bragg radii (bohr)
) -> torch.Tensor:
    """Partition weight of each point w.r.t. its owning atom."""
    natm = atom_xyz.shape[0]
    eye = torch.eye(natm, dtype=torch.bool, device=coords.device)
    # distances point -> every atom: (ngrid, natm)
    d = torch.linalg.norm(coords[:, None, :] - atom_xyz[None, :, :], dim=-1)
    # interatomic distances (natm, natm) and the size adjustment
    rab, a = _pair_tables(atom_xyz, radii)

    # mu_ij per point: (ngrid, natm, natm)
    mu = (d[:, :, None] - d[:, None, :]) / rab[None, :, :]
    nu = mu + a[None, :, :] * (1.0 - mu * mu)
    s = torch.where(eye[None, :, :], 1.0, _stepfun(nu))  # no self factor
    p_cell = torch.prod(s, dim=2)          # (ngrid, natm): P_i(r)
    w_own = torch.gather(p_cell, 1, atom_idx[:, None].long())[:, 0]
    return w_own / torch.sum(p_cell, dim=1)


def becke_weights_chunked(coords, atom_xyz, atom_idx, radii, chunk=None,
                          device="cpu") -> np.ndarray:
    """Plain version of becke_partition, on any device: host-driven chunks
    of becke_weights (bounding its (chunk, natm, natm) intermediates);
    numpy in, numpy out.  The default chunk is 65,536 points, cut for large
    molecules so that one intermediate stays at 2^27 f64 elements (1 GiB;
    9,805 points at 117 atoms)."""
    if chunk is None:
        natm = len(atom_xyz)
        chunk = min(65536, max(1024, 2**27 // (natm * natm)))

    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    xyz, rad = t(atom_xyz), t(radii)
    out = []
    for s in range(0, coords.shape[0], chunk):
        e = min(s + chunk, coords.shape[0])
        out.append(becke_weights(t(coords[s:e]), xyz,
                                 t(atom_idx[s:e], torch.int64), rad)
                   .cpu().numpy())
    return np.concatenate(out)


def becke_partition(coords, atom_xyz, atom_idx, radii,
                    device="cpu") -> np.ndarray:
    """Partition weight of each point w.r.t. its owning atom; numpy in,
    numpy out, computed on `device`.  CUDA: one K6 launch over the whole
    grid (one upload, one copy back); CPU: the plain version."""
    device = torch.device(device)
    if device.type == "cpu":
        return becke_weights_chunked(coords, atom_xyz, atom_idx, radii,
                                     device=device)
    owner = np.asarray(atom_idx)
    natm = len(atom_xyz)
    if owner.size and not 0 <= owner.min() <= owner.max() < natm:
        raise ValueError(f"K6 takes owning atoms 0..{natm - 1}, not "
                         f"{owner.min()}..{owner.max()}")

    def t(x, dtype=torch.float64):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=device).contiguous()

    xyz = t(atom_xyz)
    tab = k6_tables(xyz, t(radii))
    return _k6(t(coords), t(owner, torch.int32), xyz, tab).cpu().numpy()


# ---------------------------------------------------------------------------
# K6 (csrc/becke.cu)
# ---------------------------------------------------------------------------

K6_SOURCES = ("becke.cu",)
# K6 launches, counted by the wrapper where it launches
LAUNCHES = {"K6": 0}
_K6_LIB = None


def k6_tables(atom_xyz: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """K6's pair tables on the atoms' device: (natm, natm, 2) f64, [i, j] =
    {1 / R_ij, a_ij}, the plain version's R_ij and a_ij (the diagonal's
    factor is never used)."""
    rab, a = _pair_tables(atom_xyz, radii)
    return torch.stack([1.0 / rab, a], dim=-1).contiguous()


def k6_library() -> ctypes.CDLL:
    """K6 built and bound (the first use builds it)."""
    global _K6_LIB
    if _K6_LIB is None:
        lib = ctypes.CDLL(str(build_library("becke", K6_SOURCES)))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.becke_weights.argtypes = [i] * 2 + [p] * 6
        lib.becke_weights.restype = i
        _K6_LIB = lib
    return _K6_LIB


def _k6(coords: torch.Tensor, owner: torch.Tensor, atoms: torch.Tensor,
        tables: torch.Tensor) -> torch.Tensor:
    """One K6 launch: the partition weight of every point, (ngrid,) f64 on
    the points' device."""
    dev = coords.device
    natm = atoms.shape[0] if atoms.dim() == 2 else 0
    if not (coords.is_cuda and owner.device == dev and atoms.device == dev
            and tables.device == dev):
        raise ValueError("K6 needs the points, owners, atoms and tables on "
                         "one CUDA device")
    if (coords.dtype != torch.float64 or coords.dim() != 2
            or coords.shape[1] != 3 or not coords.is_contiguous()
            or owner.dtype != torch.int32 or owner.shape != coords.shape[:1]
            or not owner.is_contiguous() or atoms.dtype != torch.float64
            or atoms.shape != (natm, 3) or not atoms.is_contiguous()
            or tables.dtype != torch.float64
            or tables.shape != (natm, natm, 2)
            or not tables.is_contiguous()):
        raise ValueError("K6 takes contiguous (ngrid, 3) f64 points, "
                         "(ngrid,) int32 owners, (natm, 3) f64 atoms and the "
                         "tables of k6_tables")
    ngrid = coords.shape[0]
    if ngrid >= 2**31 or natm < 2:
        raise ValueError(f"K6 takes fewer than 2**31 points and 2 atoms or "
                         f"more, not {ngrid} points and {natm} atoms")
    w = torch.empty(ngrid, dtype=torch.float64, device=dev)
    if ngrid:
        with _on(dev):
            code = k6_library().becke_weights(
                ngrid, natm, coords.data_ptr(), owner.data_ptr(),
                atoms.data_ptr(), tables.data_ptr(), w.data_ptr(), _stream())
        if code != 0:
            raise RuntimeError(f"becke_weights launch ({ngrid} points, "
                               f"{natm} atoms): CUDA error {code}")
        LAUNCHES["K6"] += 1
    return w
