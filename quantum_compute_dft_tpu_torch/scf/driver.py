"""Restricted Kohn-Sham SCF driver, torch f64.

Port of the host-loop subset of ``quantum_compute_dft_tpu/scf/driver.py``:
the same Fock assembly F = Hcore + J + V_xc - 0.5 c_hf K, the same energy
decomposition E_one/E_coul/E_xc/E_ex_hf/E_nuc, the same convergence rule
(|dE| < 1e-8 and ||dD||_F < 1e-6 within 200 cycles), the SAD guess, the
level-shift controller, the charge-sloshing damping guard, FON-RKS Fermi
smearing, the ADIIS and damped-mixing mixers, and the annealing ladder
(:func:`scf_host_annealed`).

One host loop, :func:`scf_host`, with three schedules:
  * ``xc_impl='f64'`` -- every cycle in f64;
  * ``xc_impl='fast'`` (the CLI default) -- the JAX package's
    ``scf_host_staged(xc_impl='fast')``: each cycle builds XC with the
    f32 CUDA kernel (engine/fused_xc.py) and J in f64; K is f64 in-core
    and, on a density-fitted system, the f32 aux-major K (the JAX
    package's ``fast_jk='k'``).  A candidate fixed point is then verified
    by plain f64 cycles (f64 J and K), and the reported energy is one f64
    ``energy_of_dm``;
  * ``xc_impl='pallas'`` -- the JAX package's
    ``scf_host_staged(xc_impl='pallas')``: every cycle takes its XC from
    the f32 kernel (on the card the fused CUDA kernel; the name is the JAX
    CLI's), J and K in f64, the plain convergence rule, and the reported
    energies are the converged cycle's own.

:func:`scf_jit` is the JAX package's ``scf_jit`` (the whole f64 SCF as one
on-device loop): on the card, one cycle captured as CUDA graphs (three
segments around its two eigh calls) and replayed in blocks, the host
reading two device scalars per block.

J/K come from the in-core ERIs or, above the in-core size, from the
pivoted-Cholesky factor (integrals/density_fitting.py).  The JAX package's
J re-anchoring by linearity (its per-cycle f64 J is an emulated TPU
matvec) is not ported: the card's f64 J is native.

The generalized eigenproblem F C = S C e is solved by symmetric
orthogonalization X = S^(-1/2) and torch.linalg.eigh.  Every branch the
JAX package takes only on the TPU (sign-projector densities, Newton-Schulz
polishing, the 1e-8 DIIS threshold) takes its CPU side here on both
devices: the card's f64 eigh is native.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Callable, NamedTuple

import numpy as np
import torch

from quantum_compute_dft_tpu_torch.engine.coulomb import (
    coulomb_full,
    exchange_full,
)
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_energy, xc_step
from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
    _cd_coulomb_q,
    _df_exchange_f64,
    _df_exchange_fast,
)
from quantum_compute_dft_tpu_torch.scf.diis import (
    DIISGraphState,
    DIISState,
    adiis_init,
    adiis_update,
    diis_extrapolate,
    diis_init,
    diis_init_graph,
    diis_push,
    diis_update,
)
from quantum_compute_dft_tpu_torch.utils.profiling import span, spanned
from quantum_compute_dft_tpu_torch.xc.functionals import Functional

CONV_TOL_E = 1e-8
CONV_TOL_D = 1e-6
MAX_CYCLE = 200

# Oscillation guard: a half-step in the density while ||dD|| is large and
# not decreasing breaks a charge-sloshing 2-cycle; the fixed point is
# unchanged (see the JAX package's DAMP_* note).
DAMP_MIN_DNORM = 1.0
DAMP_RATIO = 0.9

# Level shifting on stall (see the JAX package's LEVEL_SHIFT note): a
# constant virtual-orbital shift F <- F + sigma (S - 1/2 S D S) engages
# when ||dD|| fails to improve by 10% for SHIFT_STALL cycles, escalates on
# no progress, and releases below SHIFT_RELEASE.
LEVEL_SHIFT = 0.5       # Eh; initial sigma
LEVEL_SHIFT_MAX = 4.0
SHIFT_STALL = 8         # non-improving cycles before (re-)engaging
SHIFT_MIN_DNORM = 1e-4  # below this DIIS is polishing; never engage
SHIFT_RELEASE = 1e-3    # engaged + ||dD|| below this -> hand back to DIIS
# 'fast' schedule: ||dD|| below the criterion for this many straight
# cycles hands the candidate to the f64 verify step without waiting for
# the |dE| test, whose f32 quantization makes it a lottery
FAST_DN_STREAK = 8
# 'fast' schedule, stall handover: where ||dD|| cannot settle below
# conv_tol_d in the kernel phase, the streak never comes (the 117-atom
# north star: ||dD|| wanders 2e-5 to 2e-4, a median of 4.5e-5, with dips
# to 4e-7).  When the best ||dD|| of STALL_WINDOW or more cycles ago has
# not fallen by STALL_RATIO in the STALL_WINDOW cycles since, and ||dD||
# is under STALL_CEILING (below which the level shift leaves DIIS to
# polish) but not under conv_tol_d, the phase has stalled: the candidate
# goes to the f64 verify as the streak's does (the JAX package's stall
# detector of its 'mixed' phase).  It hands over the lowest-||dD|| cycle's
# density: at the north star that and the current one both verify in 40
# cycles, and the lowest is the one nearest the fixed point by its residual.
STALL_WINDOW = 8
STALL_RATIO = 0.5
STALL_CEILING = SHIFT_MIN_DNORM
# The f64 verify's CDIIS bound on sum |c| (MAX_COEF_SUM elsewhere).  Its
# Fock matrices carry no f32 noise, and at a small HOMO-LUMO gap (0.009 Eh
# at the north star) the right extrapolations are large: the kernel
# phase's bound turned them into plain Roothaan steps, which slosh.  The
# verify also runs unshifted, with the shift controller unfed: from a
# candidate within ~1e-3 of the fixed point its engage/release pairs only
# reset CDIIS.  North star: no convergence in 143 verify cycles under the
# kernel phase's bound and the shift, 91 cycles under this bound with the
# shift, 40 without it.
VERIFY_MAX_COEF_SUM = 1e4
ADIIS_TO_CDIIS = 1e-2   # mixer='adiis+cdiis': ADIIS -> CDIIS handover
MIX_TO_CDIIS = 3e-3     # mixer='mix+cdiis': damped mixing -> CDIIS handover

# exact-exchange K builds, counted where they run (_build_k): "fast", the
# f32 aux-major K of the 'fast' schedule's density-fitted kernel phase;
# "f64", every other (in-core, the density-fitted f64 K, energy_of_dm's).
# scf_host reports its own call's counts on SCFResult.
K_BUILDS = {"fast": 0, "f64": 0}


def _level_shift(f, dm, s, shift: float):
    """F + shift * S (I - 1/2 D S): moves virtuals up by `shift` Eh,
    fixed point unchanged."""
    if shift == 0.0:
        return f
    return f + shift * (s - 0.5 * s @ dm @ s)


class _ShiftController:
    """Host-side stall detector driving the level shift."""

    def __init__(self, nao: int, device):
        self.nao = nao
        self.device = device
        self.shift = 0.0
        self._sigma = LEVEL_SHIFT  # (re-)engage magnitude
        self._dn_best = float("inf")
        self._stall = 0
        self.engaged_at = None  # cycle index, for tests/logs

    def _fresh(self) -> DIISState:
        return diis_init(self.nao, device=self.device)

    def update(self, cycle: int, dnorm: float):
        """Feed one cycle's ||dD||; returns a fresh DIIS state when the
        shift engages/escalates/releases (the caller must reset its
        history), else None."""
        if self.shift > 0.0:
            if dnorm < SHIFT_RELEASE:
                self.shift = 0.0
                self._stall = 0
                self._dn_best = dnorm
                return self._fresh()
            if dnorm < self._dn_best:
                self._dn_best = dnorm
                self._stall = 0
                return None
            self._stall += 1
            if self._stall >= SHIFT_STALL:
                self._sigma = min(2.0 * self._sigma, LEVEL_SHIFT_MAX)
                self.shift = self._sigma
                self._stall = 0
                self._dn_best = float("inf")
                return self._fresh()
            return None
        if dnorm < 0.9 * self._dn_best:
            self._dn_best = dnorm
            self._stall = 0
            return None
        self._stall += 1
        if self._stall >= SHIFT_STALL and dnorm > SHIFT_MIN_DNORM:
            self.shift = self._sigma
            if self.engaged_at is None:
                self.engaged_at = cycle
            self._stall = 0
            self._dn_best = float("inf")
            return self._fresh()
        return None


def _stalled(dnorms: list, conv_tol_d: float) -> bool:
    """The stall handover's test on the kernel phase's ||dD|| so far, the
    current cycle's last (see STALL_* above)."""
    if (len(dnorms) <= STALL_WINDOW
            or not conv_tol_d <= dnorms[-1] < STALL_CEILING):
        return False
    return (min(dnorms[-STALL_WINDOW:])
            > STALL_RATIO * min(dnorms[:-STALL_WINDOW]))


def _damp(dm_new, dm_old, dnorm: float, dnorm_prev: float):
    """Half step when the SCF charge-sloshes (see DAMP_* above)."""
    if dnorm > DAMP_MIN_DNORM and dnorm >= DAMP_RATIO * dnorm_prev:
        return 0.5 * (dm_new + dm_old)
    return dm_new


def _damp_dev(dm_new, dm_old, dnorm, dnorm_prev):
    """_damp on device scalars (no host read): scf_jit's form, the JAX
    package's _damp."""
    slosh = (dnorm > DAMP_MIN_DNORM) & (dnorm >= DAMP_RATIO * dnorm_prev)
    return torch.where(slosh, 0.5 * (dm_new + dm_old), dm_new)


def s_inv_sqrt(s: torch.Tensor, lindep: float = 1e-12) -> torch.Tensor:
    """Symmetric (Lowdin) orthogonalization S^(-1/2), linear-dependence
    safe (eigh only: the Newton-Schulz polish of the JAX package repairs
    the TPU's f32-quality eigh and is not needed here)."""
    w, v = torch.linalg.eigh(s)
    keep = w > lindep
    inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, w, 1.0)),
                           0.0)
    return (v * inv_sqrt) @ v.T


@dataclasses.dataclass(frozen=True, eq=False)
class SCFSystem:
    """Static per-molecule data for the SCF loop (f64 tensors on one
    device).  Identity-hashed: the packed-plane cache is keyed by it."""

    hcore: torch.Tensor
    s: torch.Tensor
    x: torch.Tensor            # S^(-1/2)
    eri: torch.Tensor | None   # (nao,)*4 in-core ERIs; None when DF
    ao: torch.Tensor           # (ngrid, nao)
    weights: torch.Tensor      # (ngrid,)
    ao_grad: torch.Tensor | None   # (3, ngrid, nao) or None
    e_nuc: float
    nocc: int
    # singly-occupied orbital count (fractional-occupation RKS for
    # odd-electron systems)
    nopen: int = 0
    # SAD initial-guess density (diag of atomic occupations); None -> Hcore
    dm_sad: torch.Tensor | None = None
    # density fitting (Cholesky factor L, W ~= L L^T), when eri is None:
    # the aux-major f64 factor (naux, nao, nao) for J, its f32 copy for the
    # kernel-phase K, and the f64 K factor (nao, nao, naux); the K factors
    # are None for functionals without exact exchange
    df_bq: torch.Tensor | None = None
    df_bq32: torch.Tensor | None = None
    df_l: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.hcore.device


class EnergyBreakdown(NamedTuple):
    e_tot: float
    e_one: float
    e_coul: float
    e_xc: float
    e_ex_hf: float


def make_system(hcore, s, eri, ao, weights, ao_grad, e_nuc, nocc,
                sad_occ=None, nopen=0, device="cpu", df_l=None,
                build_k: bool = True) -> SCFSystem:
    """Upload the setup arrays (numpy or tensors) as f64 on `device`.
    With eri=None, df_l is the Cholesky factor (nao, nao, naux); its
    aux-major copies are built here (the K factors only if build_k)."""
    def t(a):
        if a is None:
            return None
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float64))
        return a.to(dtype=torch.float64, device=device)

    s_t = t(s)
    df = {}
    if eri is None:
        l_vec = t(df_l)
        df["df_bq"] = l_vec.permute(2, 0, 1).contiguous()
        if build_k:
            df["df_l"] = l_vec
            df["df_bq32"] = df["df_bq"].to(torch.float32)
    return SCFSystem(
        hcore=t(hcore), s=s_t, x=s_inv_sqrt(s_t), eri=t(eri), ao=t(ao),
        weights=t(weights), ao_grad=t(ao_grad), e_nuc=float(e_nuc),
        nocc=int(nocc), nopen=int(nopen),
        dm_sad=None if sad_occ is None else torch.diag(t(sad_occ)),
        **df,
    )


def _density(x, f, nocc: int, nopen: int = 0):
    """Solve F C = S C e via the orthogonal basis; D = 2 C_occ C_occ^T
    (+ the singly-occupied HOMO for odd-electron systems, nopen=1)."""
    fp = x.T @ f @ x
    _, cp = torch.linalg.eigh(fp)
    return _aufbau(x @ cp, nocc, nopen)


def _aufbau(c, nocc: int, nopen: int = 0):
    """D from the orbitals C (columns by rising energy): 2 C_occ C_occ^T
    (+ the singly-occupied HOMO, nopen=1)."""
    cocc = c[:, :nocc]
    dm = 2.0 * cocc @ cocc.T
    if nopen:
        homo = c[:, nocc:nocc + nopen]
        dm = dm + homo @ homo.T
    return dm


def _fermi_occ(w: np.ndarray, mu: float, kt: float) -> np.ndarray:
    """Occupations 2/(1+exp((w-mu)/kT)) in the JAX package's overflow-
    stable form (every exp argument <= 0)."""
    t = (w - mu) / kt
    ex = np.exp(-np.abs(t))
    return np.where(t > 0.0, 2.0 * ex / (1.0 + ex), 2.0 / (1.0 + ex))


def _fermi_mu(w: np.ndarray, nelec: float, kt: float) -> float:
    """Chemical potential: 80 bisection steps on [w_0 - 10kT, w_-1 + 10kT]
    so the smeared occupations sum to nelec (host f64, on the eigenvalues
    fetched once a cycle)."""
    lo = w[0] - 10.0 * kt
    hi = w[-1] + 10.0 * kt
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if np.sum(_fermi_occ(w, mid, kt)) > nelec:
            hi = mid
        else:
            lo = mid
    return 0.5 * (lo + hi)


def _fermi_density(x, f, nelec: float, kt: float):
    """Fermi-smeared density (FON-RKS) by the raw eigh route: occupations
    2/(1+exp((e-mu)/kT)), mu bisected so they sum to nelec, rescaled to
    the exact electron count.  The treatment for near-degenerate frontier
    manifolds (CuO's open d/pi shell flip-flops its integer-occupation
    HOMO forever).  The JAX package's sign-projector/Chebyshev window
    route exists for the TPU's f32-quality eigh and is not ported."""
    fp = x.T @ f @ x
    w, cp = torch.linalg.eigh(fp)
    w_h = w.cpu().numpy()
    occ = _fermi_occ(w_h, _fermi_mu(w_h, nelec, kt), kt)
    occ = occ * (nelec / np.sum(occ))
    c = x @ cp
    return (c * torch.as_tensor(occ, dtype=c.dtype, device=c.device)) @ c.T


def _density_sanity(sys: SCFSystem, dm_prev, dm_new):
    """N-representability guard on a fresh density: trace(D S) = nelec and
    ||S D||_F <= sqrt(2 nelec).  When violated, keep the previous density
    and return a residual of 1e3 so the cycle cannot count as converged.
    Returns (dm, 0.0) when sane."""
    nelec = 2 * sys.nocc + sys.nopen
    tr_s = torch.sum(dm_new * sys.s.T)
    sd = sys.s @ dm_new
    nrm = torch.sqrt(torch.abs(torch.sum(sd * sd.T)))
    sane = ((torch.abs(tr_s - nelec) < 0.5)
            & (nrm < (2.0 * nelec) ** 0.5 + 1.0)
            & torch.all(torch.isfinite(dm_new)))
    return (torch.where(sane, dm_new, dm_prev),
            torch.where(sane, 0.0, 1e3).to(dm_new.dtype))


# per-system packed f32 planes for the fused XC kernel: the f32 transpose
# of the AO planes happens once per SCFSystem, not once per cycle
_PACK_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _packed_for(sys: SCFSystem, needs_grad: bool):
    from quantum_compute_dft_tpu_torch.engine.fused_xc import pack_inputs

    per_sys = _PACK_CACHE.setdefault(sys, {})
    ent = per_sys.get(needs_grad)
    if ent is None:
        ent = pack_inputs(sys.ao, sys.weights, sys.ao_grad,
                          needs_grad=needs_grad)
        per_sys[needs_grad] = ent
    return ent


def _fused_xc(sys: SCFSystem, functional: Functional, dm):
    from quantum_compute_dft_tpu_torch.engine.fused_xc import fused_xc

    aot, wt, grads = _packed_for(sys, functional.needs_grad)
    return fused_xc(functional, dm, aot, wt, grads, sys.hcore.shape[0])


def _build_j(sys: SCFSystem, dm):
    """f64 J: in-core, or the aux-major Cholesky factor."""
    if sys.eri is not None:
        return coulomb_full(sys.eri, dm)
    return _cd_coulomb_q(sys.df_bq, dm)


def _build_k(sys: SCFSystem, dm, fast: bool = False):
    """K: in-core f64; density-fitted, the f32 aux-major K when `fast`
    (kernel-phase cycles) and the f64 K otherwise."""
    fast = fast and sys.eri is None
    K_BUILDS["fast" if fast else "f64"] += 1
    if sys.eri is not None:
        return exchange_full(sys.eri, dm)
    if fast:
        return _df_exchange_fast(sys.df_bq32, dm)
    return _df_exchange_f64(sys.df_l, dm)


def _energies(dm_new, sys: SCFSystem, j, k, e_xc, c_hf: float):
    """Stacked [e_tot, e_one, e_coul, e_xc, e_ex] (one tensor, so the host
    fetches them in one transfer)."""
    e_one = torch.sum(dm_new * sys.hcore)
    e_coul = 0.5 * torch.sum(dm_new * j)
    e_ex = (-0.25 * c_hf * torch.sum(dm_new * k) if k is not None
            else torch.zeros_like(e_one))
    e_tot = e_one + e_coul + e_xc + e_ex + sys.e_nuc
    return torch.stack([e_tot, e_one, e_coul, e_xc, e_ex])


def _cycle_tail(sys: SCFSystem, functional: Functional, dm, diis, e_xc,
                vxc, shift: float, smear_kt: float, mixer: str,
                fast_k: bool = False):
    """J, K, Fock, the mixer (CDIIS; ADIIS, `diis` then an ADIISState;
    'mix' leaves `diis` untouched), level shift, eigh density (Fermi-
    smeared when smear_kt > 0), energies."""
    with span("scf.j"):
        j = _build_j(sys, dm)
    c_hf = functional.hyb_coeff
    k = None
    f = sys.hcore + j + vxc
    if c_hf != 0.0:
        with span("scf.k"):
            k = _build_k(sys, dm, fast=fast_k)
        f = f - 0.5 * c_hf * k
    with span("scf.mix"):
        if mixer == "adiis":
            diis, f = adiis_update(diis, f, dm)
        elif mixer != "mix":
            diis, f = diis_update(diis, f, dm, sys.s, sys.x)
    with span("scf.eigh"):
        f = _level_shift(f, dm, sys.s, shift)
        if smear_kt > 0.0:
            dm_new = _fermi_density(sys.x, f, 2 * sys.nocc + sys.nopen,
                                    smear_kt)
        else:
            dm_new = _density(sys.x, f, sys.nocc, sys.nopen)
    return dm_new, diis, lambda d: _energies(d, sys, j, k, e_xc, c_hf)


def scf_iteration(sys: SCFSystem, functional: Functional, dm, diis,
                  shift: float = 0.0, smear_kt: float = 0.0,
                  mixer: str = "cdiis", mix_alpha: float = 0.2):
    """One f64 SCF cycle -> (dm_new, diis, energies [5], dnorm).
    mixer='mix' is damped linear mixing, D + alpha (D_new - D); dnorm is
    then the blended step, as in the JAX package's scf_host."""
    with span("scf.xc"):
        e_xc, vxc = xc_step(functional, dm, sys.ao, sys.weights,
                            sys.ao_grad)
    dm_new, diis, energies = _cycle_tail(sys, functional, dm, diis, e_xc,
                                         vxc, shift, smear_kt, mixer)
    if mixer == "mix":
        dm_new = dm + mix_alpha * (dm_new - dm)
    return dm_new, diis, energies(dm_new), torch.linalg.norm(dm_new - dm)


def scf_iteration_fast(sys: SCFSystem, functional: Functional, dm, diis,
                       shift: float = 0.0, smear_kt: float = 0.0,
                       mixer: str = "cdiis", mix_alpha: float = 0.2,
                       fast_k: bool = True):
    """One kernel-phase cycle of the 'fast' and 'pallas' schedules: f32 XC
    from the fused kernel, then the tail (the f32 K when density-fitted
    and fast_k, the 'fast' schedule's; f64 K otherwise), with the density
    sanity guard (scf_host_staged's cycle).  -> (dm_new, diis, energies
    [5], dnorm).  Under mixer='mix' dnorm stays the raw map residual, as in
    the JAX package's staged tail."""
    with span("scf.xc"):
        e_xc, vxc = _fused_xc(sys, functional, dm)
    dm_new, diis, energies = _cycle_tail(sys, functional, dm, diis, e_xc,
                                         vxc, shift, smear_kt, mixer,
                                         fast_k=fast_k)
    with span("scf.sanity"):
        dm_new, insane = _density_sanity(sys, dm, dm_new)
    dnorm = torch.linalg.norm(dm_new - dm) + insane
    if mixer == "mix":
        dm_new = dm + mix_alpha * (dm_new - dm)
    return dm_new, diis, energies(dm_new), dnorm


@spanned("scf.energy_of_dm")
def energy_of_dm(sys: SCFSystem, functional: Functional,
                 dm) -> EnergyBreakdown:
    """Self-consistent f64 total energy at a given density (every term
    from THIS dm: variationally stationary near the fixed point)."""
    j = _build_j(sys, dm)
    e_xc = xc_energy(functional, dm, sys.ao, sys.weights, sys.ao_grad)
    c_hf = functional.hyb_coeff
    k = _build_k(sys, dm) if c_hf != 0.0 else None
    return EnergyBreakdown(*_energies(dm, sys, j, k, e_xc, c_hf).tolist())


def initial_guess(sys: SCFSystem) -> torch.Tensor:
    """SAD when available, else the Hcore guess."""
    if sys.dm_sad is not None:
        return sys.dm_sad
    return _density(sys.x, sys.hcore, sys.nocc, sys.nopen)


@dataclasses.dataclass
class SCFResult:
    converged: bool
    n_iter: int
    dm: torch.Tensor
    energy: EnergyBreakdown
    e_tot: float
    level_shift: float = 0.0
    shift_engaged_at: int | None = None
    # 'fast' and 'pallas' schedules: cycles whose XC ran on the fused f32
    # kernel, and the f64 verify cycles after them ('fast' only)
    fast_cycles: int = 0
    verify_cycles: int = 0
    # 'fast' only: how the kernel phase ended ("rule", "streak" or
    # "stall"; None without a handover), and its cycles after the one with
    # the lowest ||dD||, up to the handover or the end
    handover: str | None = None
    stall_wait_cycles: int = 0
    # exact-exchange K builds of the call (K_BUILDS), energy_of_dm's
    # included: the f32 aux-major K ('fast', density-fitted kernel phase)
    # and the f64 K; 0 and 0 for a functional without exact exchange
    k_builds_fast: int = 0
    k_builds_f64: int = 0
    # electronic temperature this result was converged at (0 = integer
    # occupations); scf_host_annealed reports its coldest converged rung
    smear_kt: float = 0.0


@spanned("scf")
def scf_host(
    sys: SCFSystem,
    functional: Functional,
    callback: Callable | None = None,
    max_cycle: int = MAX_CYCLE,
    conv_tol_e: float = CONV_TOL_E,
    conv_tol_d: float = CONV_TOL_D,
    dm0=None,
    xc_impl: str = "f64",
    smear_kt: float = 0.0,
    mixer: str = "cdiis",
    mix_alpha: float = 0.2,
    checkpoint_cb: Callable | None = None,
    checkpoint_every: int = 25,
) -> SCFResult:
    """Host SCF loop; callback(cycle, eb, dE, dnorm) after each cycle.

    xc_impl='f64': every cycle is scf_iteration, as the JAX package's
    scf_host (the result carries the converged cycle's energies).

    xc_impl='fast' (the in-core scf_host_staged(xc_impl='fast')): kernel-
    phase cycles (scf_iteration_fast) until the convergence rule holds,
    ||dD|| has met it for FAST_DN_STREAK straight cycles, or ||dD|| has
    stalled above it (_stalled; the lowest-||dD|| cycle's density is
    handed over).  An all-f32 fixed point can be SPURIOUS for heavy
    elements (steep Fock scales push the f32 rounding floor above the
    convergence window: H2Se -1.2e-4 and HBr +2.3e-4 Eh in the JAX
    package), so the candidate is verified by f64 cycles from it, with a
    fresh CDIIS history under VERIFY_MAX_COEF_SUM and no ADIIS, mixing or
    level shift, until the rule holds; the reported energy is one f64
    energy_of_dm of the returned density.  The cycle count and the
    callback span both phases; SCFResult.handover says how the kernel
    phase ended.

    xc_impl='pallas' (scf_host_staged(xc_impl='pallas')): every cycle is a
    kernel-phase cycle with f64 J and K, to the plain convergence rule (no
    ||dD|| streak, no f64 verify); the result carries the converged
    cycle's own energies.

    smear_kt > 0 runs FON-RKS (Fermi-smeared occupations at that
    electronic temperature in Eh) in every cycle of any schedule.

    mixer: 'cdiis'; 'adiis+cdiis' (energy-based ADIIS, handing over to a
    fresh CDIIS history once ||dD|| < ADIIS_TO_CDIIS); 'mix+cdiis' (damped
    linear mixing with mix_alpha, then CDIIS below MIX_TO_CDIIS) or 'mix'
    (never hands over).  While ADIIS or mixing runs there is no level shift
    and the shift controller is not fed.

    checkpoint_cb(cycles done, dm (numpy), e_tot) is called after every
    checkpoint_every-th cycle that does not end the run (see
    scf.checkpoint.periodic_saver), as the JAX package's scf_host_staged
    calls it: with the density carried into the next cycle and the energy
    that the cycle reported, whose J, K and XC come from the cycle's input
    density, so the stored e_tot is one cycle older than dm, as in the JAX
    loop (resume reads only dm).

    Every cycle's V_xc is under functional.sigma_factor (dE_xc/dD, or
    the JAX package's under functional.jax_potential())."""
    if xc_impl not in ("f64", "fast", "pallas"):
        raise ValueError(f"xc_impl must be 'f64', 'fast' or 'pallas', not "
                         f"{xc_impl!r}")
    dm = initial_guess(sys) if dm0 is None else torch.as_tensor(
        dm0, dtype=torch.float64, device=sys.device)
    nao = dm.shape[0]
    use_adiis = mixer.startswith("adiis")
    use_mix = mixer.startswith("mix")
    diis = (adiis_init if use_adiis else diis_init)(nao, device=sys.device)
    shiftc = _ShiftController(nao, sys.device)
    e_old = 0.0
    dnorm_prev = float("inf")
    kernel_phase = xc_impl != "f64"   # 'fast': then f64 verify cycles
    kernel_step = functools.partial(scf_iteration_fast,
                                    fast_k=xc_impl == "fast")
    k0 = dict(K_BUILDS)
    dn_streak = 0
    n_fast = 0
    dn_hist = []     # the kernel phase's ||dD||, for the stall handover
    best = None      # its lowest ||dD||: (||dD||, cycle, that density)
    handover = None
    done = None    # the converged cycle and its density
    for cycle in range(max_cycle):
        with span("scf.cycle"):
            step = kernel_step if kernel_phase else scf_iteration
            dm_new, diis, en, dn_t = step(
                sys, functional, dm, diis,
                shift=(0.0 if use_adiis or use_mix or handover is not None
                       else shiftc.shift),
                smear_kt=smear_kt,
                mixer="adiis" if use_adiis else "mix" if use_mix else "cdiis",
                mix_alpha=mix_alpha)
            n_fast += kernel_phase
            with span("scf.fetch"):
                stat = torch.cat([en, dn_t[None]]).tolist()  # one per cycle
            eb, dnorm = EnergyBreakdown(*stat[:5]), stat[5]
            de = eb.e_tot - e_old
            if callback:
                callback(cycle, eb, de, dnorm)
            converged = abs(de) < conv_tol_e and dnorm < conv_tol_d
            if xc_impl == "fast" and kernel_phase:
                dn_hist.append(dnorm)
                if best is None or dnorm < best[0]:
                    best = dnorm, n_fast - 1, dm_new
                dn_streak = dn_streak + 1 if dnorm < conv_tol_d else 0
                if converged:
                    handover = "rule"
                elif dn_streak >= FAST_DN_STREAK:
                    handover = "streak"
                elif _stalled(dn_hist, conv_tol_d):
                    handover = "stall"
                converged = handover is not None
            if converged and (not kernel_phase or xc_impl == "pallas"):
                done = cycle, dm_new
                break
            if use_adiis and dnorm < ADIIS_TO_CDIIS:
                use_adiis = False
                diis = diis_init(nao, device=sys.device)  # fresh CDIIS
            # the two JAX loops differ here, and each is copied: the f64
            # loop's dnorm is the blended step (alpha x the raw map
            # residual), which scf_host rescales; the kernel phase's dnorm
            # is the raw residual, which scf_host_staged tests as it is
            mix_dn = dnorm if kernel_phase else dnorm / mix_alpha
            if use_mix and "+" in mixer and mix_dn < MIX_TO_CDIIS:
                use_mix = False   # CDIIS takes over; its history is empty
            if not (use_adiis or use_mix or handover is not None):
                fresh = shiftc.update(cycle, dnorm)
                if fresh is not None:
                    diis = fresh
            if converged:
                # candidate fixed point: verify it with f64 cycles, a fresh
                # CDIIS history (the f32-floor history is noise) and no
                # level shift (see VERIFY_MAX_COEF_SUM)
                with span("scf.handover"):
                    kernel_phase = use_adiis = use_mix = False
                    diis = diis_init(nao, device=sys.device,
                                     max_coef_sum=VERIFY_MAX_COEF_SUM)
                    dm = best[2] if handover == "stall" else dm_new
            else:
                dm = _damp(dm_new, dm, dnorm, dnorm_prev)
            dnorm_prev = dnorm
            e_old = eb.e_tot
            if (checkpoint_cb is not None and checkpoint_every > 0
                    and (cycle + 1) % checkpoint_every == 0):
                checkpoint_cb(cycle + 1, dm.cpu().numpy(), e_old)
    phase = dict(handover=handover, stall_wait_cycles=(
        n_fast - 1 - best[1] if best is not None else 0))
    if done is not None:
        cycle, dm_new = done
        if xc_impl == "fast":
            eb = energy_of_dm(sys, functional, dm_new)
        return SCFResult(True, cycle + 1, dm_new, eb, eb.e_tot,
                         level_shift=shiftc.shift,
                         shift_engaged_at=shiftc.engaged_at,
                         fast_cycles=n_fast,
                         verify_cycles=cycle + 1 - n_fast,
                         smear_kt=smear_kt, **phase, **_k_builds_since(k0))
    eb = (energy_of_dm(sys, functional, dm) if max_cycle > 0
          else EnergyBreakdown(*(float("nan"),) * 5))
    return SCFResult(False, max_cycle, dm, eb, eb.e_tot,
                     level_shift=shiftc.shift,
                     shift_engaged_at=shiftc.engaged_at,
                     fast_cycles=n_fast, verify_cycles=max_cycle - n_fast,
                     smear_kt=smear_kt, **phase, **_k_builds_since(k0))


def _k_builds_since(k0: dict) -> dict:
    """SCFResult's K build counts since the snapshot k0 of K_BUILDS."""
    return dict(k_builds_fast=K_BUILDS["fast"] - k0["fast"],
                k_builds_f64=K_BUILDS["f64"] - k0["f64"])


ANNEAL_KTS = (0.5, 0.35, 0.25, 0.2, 0.15, 0.1)


def scf_host_annealed(
    sys: SCFSystem,
    functional: Functional,
    kts: tuple[float, ...] = ANNEAL_KTS,
    runner: Callable | None = None,
    finish_integer: bool = True,
    rung_conv_tol_e: float | None = None,
    rung_conv_tol_d: float | None = None,
    **kwargs,
) -> SCFResult:
    """FON-RKS annealing ladder (the JAX package's scf_host_annealed):
    converge at the hottest electronic temperature, then re-converge at
    each colder kT warm-started from the previous density; rungs below the
    first failure are not attempted.  Returns the result at the coldest kT
    that converged (its `smear_kt` says which), the recipe for systems
    whose integer-occupation SCF has no reachable fixed point (CuO).

    finish_integer: after the coldest converged rung, one integer-
    occupation run (max_cycle at most 100) warm-started from its density;
    returned (smear_kt 0) when it converges.  rung_conv_tol_e/d loosen the
    smeared rungs' rule only.  runner: the SCF loop (default scf_host,
    f64 unless kwargs pass xc_impl)."""
    run = runner if runner is not None else scf_host
    best = None
    dm0 = kwargs.pop("dm0", None)
    rung_kw = dict(kwargs)
    if rung_conv_tol_e is not None:
        rung_kw["conv_tol_e"] = rung_conv_tol_e
    if rung_conv_tol_d is not None:
        rung_kw["conv_tol_d"] = rung_conv_tol_d
    for kt in kts:
        r = run(sys, functional, smear_kt=kt, dm0=dm0, **rung_kw)
        r.smear_kt = kt
        if not r.converged:
            break
        best = r
        dm0 = r.dm
    if best is not None and finish_integer:
        mc = kwargs.pop("max_cycle", MAX_CYCLE)
        ri = run(sys, functional, smear_kt=0.0, dm0=best.dm,
                 max_cycle=min(mc, 100), **kwargs)
        if ri.converged:
            ri.smear_kt = 0.0
            return ri
    return best if best is not None else r


# cycles replayed on the card between two reads of (done, cycle); the
# replays after convergence are masked no-ops
JIT_BLOCK = 8


def _jit_carry(sys: SCFSystem) -> dict:
    """scf_jit's carry, all device tensors: the SAD density, the CDIIS
    history and its count, the last cycle's energies [5], e_old,
    dnorm_prev, cycle and done (the JAX loop's carry)."""
    dm0 = initial_guess(sys)
    diis = diis_init_graph(dm0.shape[0], device=sys.device)

    def scalar(v, dtype=torch.float64):
        return torch.full((), v, dtype=dtype, device=sys.device)

    return {"dm": dm0.clone(), "f_buf": diis.f_buf, "e_buf": diis.e_buf,
            "nsaved": diis.nsaved,
            "energies": torch.zeros(5, dtype=torch.float64, device=sys.device),
            "e_old": scalar(0.0), "dnorm_prev": scalar(float("inf")),
            "cycle": scalar(0, torch.int64), "done": scalar(False, torch.bool)}


def _jit_cycle(sys: SCFSystem, functional: Functional, st: dict,
               max_cycle: int):
    """One cycle of scf_jit on the carry `st`, written back in place and
    masked: once done, or at max_cycle, it leaves `st` as it is.  The body
    of the JAX loop: an f64 scf_iteration with CDIIS (no level shift, ADIIS
    or smearing), the device-side damping, and done = |dE| < CONV_TOL_E and
    ||dD|| < CONV_TOL_D (the module constants).  No host reads: the cycle is
    a generator that yields each symmetric matrix it needs diagonalized
    (the CDIIS B matrix, then the orthogonalized Fock matrix) and is sent
    back its (eigenvalues, eigenvectors)."""
    dm = st["dm"]
    active = ~st["done"] & (st["cycle"] < max_cycle)
    e_xc, vxc = xc_step(functional, dm, sys.ao, sys.weights, sys.ao_grad)
    j = _build_j(sys, dm)
    c_hf = functional.hyb_coeff
    k = None
    f = sys.hcore + j + vxc
    if c_hf != 0.0:
        k = _build_k(sys, dm)
        f = f - 0.5 * c_hf * k
    diis, b_s = diis_push(
        DIISGraphState(st["f_buf"], st["e_buf"], st["nsaved"]), f, dm,
        sys.s, sys.x)
    w_b, v_b = yield b_s
    f = diis_extrapolate(diis, f, w_b, v_b)
    _, cp = yield sys.x.T @ f @ sys.x
    dm_new = _aufbau(sys.x @ cp, sys.nocc, sys.nopen)
    en = _energies(dm_new, sys, j, k, e_xc, c_hf)
    dnorm = torch.linalg.norm(dm_new - dm)
    done = (torch.abs(en[0] - st["e_old"]) < CONV_TOL_E) & (dnorm < CONV_TOL_D)
    new = {"dm": _damp_dev(dm_new, dm, dnorm, st["dnorm_prev"]),
           "f_buf": diis.f_buf, "e_buf": diis.e_buf, "nsaved": diis.nsaved,
           "energies": en, "e_old": en[0], "dnorm_prev": dnorm,
           "cycle": st["cycle"] + 1, "done": done}
    for key, val in new.items():
        st[key].copy_(torch.where(active, val, st[key]))


def _run_cycle(gen) -> None:
    """Drive a _jit_cycle generator eagerly, with torch.linalg.eigh."""
    try:
        mat = next(gen)
        while True:
            mat = gen.send(torch.linalg.eigh(mat))
    except StopIteration:
        pass


def _capture_cycle(sys: SCFSystem, functional: Functional, st: dict,
                   max_cycle: int) -> Callable[[], None]:
    """One _jit_cycle on `st` captured as CUDA graphs -> replay().

    torch.linalg.eigh checks its result's info flag on the host, a sync
    that a capture forbids, so the cycle is captured in three segments
    around its two eigh calls (the 8x8 CDIIS matrix and the nao x nao Fock
    matrix), sharing one memory pool; replay() runs segment, eager eigh
    into static buffers, segment, eager eigh, segment.  Warmed up first on
    a side stream, on a copy of the carry."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _run_cycle(_jit_cycle(sys, functional,
                              {k: v.clone() for k, v in st.items()},
                              max_cycle))
    torch.cuda.current_stream().wait_stream(side)
    gen = _jit_cycle(sys, functional, st, max_cycle)
    graphs, mats, outs = [], [], []
    send = None
    while True:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=graphs[0].pool() if graphs else None):
            try:
                mat = next(gen) if send is None else gen.send(send)
            except StopIteration:
                mat = None
        graphs.append(g)
        if mat is None:
            break
        n = mat.shape[-1]
        send = (torch.empty(n, dtype=mat.dtype, device=mat.device),
                torch.empty((n, n), dtype=mat.dtype, device=mat.device))
        mats.append(mat)
        outs.append(send)

    def replay():
        for g, mat, (w, v) in zip(graphs, mats, outs):
            g.replay()
            w_e, v_e = torch.linalg.eigh(mat)
            w.copy_(w_e)
            v.copy_(v_e)
        graphs[-1].replay()

    return replay


def scf_jit(sys: SCFSystem, functional: Functional,
            max_cycle: int = MAX_CYCLE):
    """The whole f64 SCF as one on-device loop (the JAX package's scf_jit,
    a lax.while_loop): -> (dm, EnergyBreakdown, n_iter, done).

    On the card one cycle (_jit_cycle) is captured as CUDA graphs, its
    whole carry in static device tensors, every update masked by `done`,
    and the host replays it in blocks of JIT_BLOCK cycles, reading (done,
    cycle) once per block; the replays after convergence change nothing,
    so n_iter is the while-loop's.  A failed capture raises: there is no
    eager route on the card.  On the CPU the same cycle runs eagerly, one
    per host check."""
    st = _jit_carry(sys)
    if sys.device.type == "cuda":
        try:
            cycle = _capture_cycle(sys, functional, st, max_cycle)
        except Exception as e:
            raise RuntimeError(f"scf_jit: CUDA graph capture failed ({e})"
                               ) from e
        block = JIT_BLOCK
    else:
        def cycle():
            _run_cycle(_jit_cycle(sys, functional, st, max_cycle))
        block = 1
    while True:
        for _ in range(block):
            cycle()
        done, n_iter = torch.stack([st["done"].to(torch.int64),
                                    st["cycle"]]).tolist()
        if done or n_iter >= max_cycle:
            break
    return (st["dm"], EnergyBreakdown(*st["energies"].tolist()), n_iter,
            bool(done))
