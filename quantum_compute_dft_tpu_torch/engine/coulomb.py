"""Coulomb J and exact-exchange K from the in-core ERI tensor, torch f64.

Port of ``quantum_compute_dft_tpu/engine/coulomb.py``: plain float64
contractions (cuBLAS on the card), as the JAX package left them to XLA.
"""

from __future__ import annotations

import torch


def coulomb_full(eri: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """J_ij = sum_kl (ij|kl) D_kl."""
    n = dm.shape[0]
    return (eri.reshape(n * n, n * n) @ dm.reshape(-1)).reshape(n, n)


def exchange_full(eri: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """K_ik = sum_jl (ij|kl) D_jl."""
    return torch.einsum("ijkl,jl->ik", eri, dm)
