"""Complete SCF driven by the independent C++ host engine.

Port of ``quantum_compute_dft_tpu/runtime/native_scf.py``, numpy in: the
PySCF-oracle substitute of an environment without PySCF.  Two
independently written engines -- the port's torch autodiff path (engine/)
and the C++ dual-number path (runtime/dft_host.cpp) -- agreeing on a FULL
SCF, not just per-call spot checks.  The loop mirrors the reference
driver's structure (ref dft.py:199-266): per-cycle J and E_xc/V_xc
through the C ABI wrapper (the reference's DFTSolverWrapper call pattern,
ref dft.py:199-236), exact-exchange K as the driver-level einsum
(ref dft.py:218), scipy generalized eigh (ref dft.py:227), a plain numpy
CDIIS (ref dft.py:184,225), the reference's convergence rule and energy
decomposition (ref dft.py:230-243).  No torch anywhere in the
cycle: it runs on the host by design, an engine apart from the SCF it
checks.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

from quantum_compute_dft_tpu_torch.runtime.ffi import HostSolverWrapper


class _CDIIS:
    """Plain Pulay CDIIS on host numpy (error vector F D S - S D F)."""

    def __init__(self, max_vec: int = 8):
        self.max_vec = max_vec
        self.focks: list[np.ndarray] = []
        self.errs: list[np.ndarray] = []

    def update(self, s, dm, f):
        err = f @ dm @ s - s @ dm @ f
        self.focks.append(f.copy())
        self.errs.append(err.ravel())
        if len(self.focks) > self.max_vec:
            self.focks.pop(0)
            self.errs.pop(0)
        n = len(self.focks)
        if n == 1:
            return f
        b = -np.ones((n + 1, n + 1))
        b[-1, -1] = 0.0
        for i in range(n):
            for j in range(n):
                b[i, j] = self.errs[i] @ self.errs[j]
        rhs = np.zeros(n + 1)
        rhs[-1] = -1.0
        try:
            c = np.linalg.solve(b, rhs)[:n]
        except np.linalg.LinAlgError:
            return f
        return sum(ci * fi for ci, fi in zip(c, self.focks))


def run_native_scf(
    functional: str,
    hcore: np.ndarray,
    s: np.ndarray,
    eri: np.ndarray,
    ao: np.ndarray,
    weights: np.ndarray,
    ao_grad: np.ndarray | None,
    e_nuc: float,
    nocc: int,
    max_cycle: int = 200,
    conv_tol_e: float = 1e-8,
    conv_tol_d: float = 1e-6,
    sigma_factor: float = 4.0,
):
    """-> (e_tot, dm, n_iter, converged); all compute through the C++
    engine + numpy/scipy, mirroring the reference driver (sigma_factor:
    HostSolverWrapper's, 2.0 for the JAX package's V_xc)."""
    functional = functional.upper()
    c_hf = 0.2 if functional == "B3LYP" else 0.0  # ref dft.py:197
    nao = hcore.shape[0]
    w = HostSolverWrapper(functional, sigma_factor=sigma_factor)
    eri2d = np.ascontiguousarray(np.asarray(eri).reshape(nao * nao, nao * nao))
    eri4d = np.asarray(eri)
    ao = np.ascontiguousarray(np.asarray(ao))
    weights = np.ascontiguousarray(np.asarray(weights))
    if ao_grad is not None:
        ao_grad = np.ascontiguousarray(np.asarray(ao_grad))

    # Hcore initial guess (ref dft.py:181-182)
    e_orb, c = sla.eigh(hcore, s)
    dm = 2.0 * c[:, :nocc] @ c[:, :nocc].T
    diis = _CDIIS()
    e_old = 0.0
    j = np.zeros_like(dm)
    vxc = np.zeros_like(dm)
    for cycle in range(max_cycle):
        dm_c = np.ascontiguousarray(dm)
        w.compute_coulomb(eri2d, dm_c, j)
        vxc[:] = 0.0
        e_xc = w.compute_xc(dm_c, ao, weights, vxc, ao_grad)
        vxc_s = 0.5 * (vxc + vxc.T)  # ref dft.py:212
        f = hcore + j + vxc_s
        if c_hf:
            k = np.einsum("ijkl,jl->ik", eri4d, dm)  # ref dft.py:218
            f -= 0.5 * c_hf * k
        f = diis.update(s, dm, f)
        e_orb, c = sla.eigh(f, s)
        dm_new = 2.0 * c[:, :nocc] @ c[:, :nocc].T
        # energy decomposition (ref dft.py:230-236)
        e_tot = (
            np.sum(dm_new * hcore) + 0.5 * np.sum(dm_new * j) + e_xc + e_nuc
        )
        if c_hf:
            e_tot -= 0.25 * c_hf * np.sum(dm_new * k)
        d_norm = np.linalg.norm(dm_new - dm)
        de = e_tot - e_old
        dm, e_old = dm_new, e_tot
        if abs(de) < conv_tol_e and d_norm < conv_tol_d:  # ref dft.py:243
            return e_tot, dm, cycle + 1, True
    return e_tot, dm, max_cycle, False
