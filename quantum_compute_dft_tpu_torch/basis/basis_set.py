"""Molecular basis-set construction.

Builds, from a Molecule and the STO-3G tables in data.py, the flattened
array structures consumed by the integral engine and the AO evaluator:

  * a *cartesian AO table* (one row per cartesian component, each a
    contraction of nprim primitives sharing one monomial) for the
    McMurchie-Davidson integral kernels, plus the sparse cartesian ->
    real-spherical-harmonic transform (6d -> 5d, s/p passthrough);
  * a *flat primitive-term table* (one row per spherical AO, padded to a
    fixed number of (monomial, exponent, weight) terms) for grid AO
    evaluation on the VPU.

Spherical harmonics are used for d shells, matching the reference's nao
(PySCF default spherical basis; ref grid.py:50).  All contracted functions
are renormalized to unit self-overlap; SCF energies are invariant to AO
scaling, so this is safe regardless of the source-table convention.
"""

from __future__ import annotations

import dataclasses
from math import factorial, gamma, pi, sqrt

import numpy as np

from quantum_compute_dft_tpu_torch.basis.data import element_shells
from quantum_compute_dft_tpu_torch.mol.molecule import Molecule

NPRIM = 3  # STO-3G contraction length

# Cartesian monomial order per l.
def _monomials(l: int):
    return [
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    ]


CART_MONOMIALS = {l: _monomials(l) for l in range(5)}

# Real solid harmonics as combinations of cartesian monomials, normalized so
# that S_lm = r^l * Ybar_lm with Ybar orthonormal on the unit sphere.
# l=2 order: m = -2, -1, 0, +1, +2  ->  xy, yz, (3z^2-r^2), xz, (x^2-y^2).
_C1 = sqrt(15.0 / (4.0 * pi))       # xy, yz, xz
_C2 = sqrt(5.0 / (16.0 * pi))       # 3z^2 - r^2
_C3 = sqrt(15.0 / (16.0 * pi))      # x^2 - y^2


def _solid_harmonics_numeric(l: int) -> np.ndarray:
    """(2l+1, ncart(l)) coefficients of r^l Ybar_lm over the monomials of
    CART_MONOMIALS[l], with Ybar the orthonormal real spherical harmonics.

    Generated numerically: sample monomials on a Lebedev grid, orthonormalize
    the harmonic subspace by eigendecomposition of the Gram matrix, then
    rotate to the canonical real-Ylm ordering via scipy's sph_harm.  Exact
    to quadrature precision (the integrands are polynomials); used for
    l >= 3 where hand-tabulation is error-prone (auxiliary f/g shells)."""
    from scipy.integrate import lebedev_rule
    from scipy.special import sph_harm_y

    pts, w = lebedev_rule(2 * l + 3)
    x, y, z = pts  # (3, npts)
    theta = np.arccos(np.clip(z, -1, 1))
    phi = np.arctan2(y, x)
    monos = np.stack(
        [x ** a * y ** b * z ** c for (a, b, c) in CART_MONOMIALS[l]]
    )  # (nc, npts)
    # real spherical harmonics Ybar_lm on the samples
    rows = []
    for m in range(-l, l + 1):
        ylm = sph_harm_y(l, abs(m), theta, phi)
        if m < 0:
            ybar = np.sqrt(2.0) * (-1.0) ** m * ylm.imag
        elif m == 0:
            ybar = ylm.real
        else:
            ybar = np.sqrt(2.0) * (-1.0) ** m * ylm.real
        rows.append(ybar)
    ybar = np.stack(rows)  # (2l+1, npts)
    gram = (monos * w) @ monos.T          # <mono_i, mono_j> on the sphere
    proj = (ybar * w) @ monos.T           # <Ybar_m, mono_j>
    return proj @ np.linalg.pinv(gram)


SPH_FROM_CART = {
    0: np.array([[sqrt(1.0 / (4.0 * pi))]]),
    1: np.eye(3) * sqrt(3.0 / (4.0 * pi)),
    # rows: m; cols: (xx, xy, xz, yy, yz, zz)
    2: np.array(
        [
            [0.0, _C1, 0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0, _C1, 0.0],
            [-_C2, 0.0, 0.0, -_C2, 0.0, 2.0 * _C2],
            [0.0, 0.0, _C1, 0.0, 0.0, 0.0],
            [_C3, 0.0, 0.0, -_C3, 0.0, 0.0],
        ]
    ),
    3: _solid_harmonics_numeric(3),
    4: _solid_harmonics_numeric(4),
}


def double_factorial(n: int) -> int:
    if n <= 0:
        return 1
    r = 1
    while n > 1:
        r *= n
        n -= 2
    return r


def radial_gto_norm(l: int, alpha: float) -> float:
    """Norm of r^l exp(-alpha r^2) under \\int R^2 r^2 dr."""
    k = 2 * l + 2
    integral = gamma((k + 1) / 2.0) / (2.0 * (2.0 * alpha) ** ((k + 1) / 2.0))
    return 1.0 / sqrt(integral)


def cart_prim_norm(lx: int, ly: int, lz: int, alpha: float) -> float:
    """Norm of x^lx y^ly z^lz exp(-alpha r^2) in 3D."""
    L = lx + ly + lz
    num = (2.0 * alpha / pi) ** 0.75 * (4.0 * alpha) ** (L / 2.0)
    den = sqrt(
        double_factorial(2 * lx - 1)
        * double_factorial(2 * ly - 1)
        * double_factorial(2 * lz - 1)
    )
    return num / den


@dataclasses.dataclass(frozen=True)
class Shell:
    atom: int
    l: int
    center: np.ndarray          # (3,) bohr
    alphas: np.ndarray          # (NPRIM,)
    coeffs: np.ndarray          # (NPRIM,) radial-normalized-primitive coeffs,
    #                             renormalized so the contraction has unit norm
    label: str                  # e.g. "O 2sp(p)"


@dataclasses.dataclass
class BasisSet:
    shells: list[Shell]
    nao: int                    # spherical AO count
    ncart: int                  # cartesian AO count
    # --- cartesian AO tables for integrals (row per cartesian AO) ---
    cart_powers: np.ndarray     # (ncart, 3) int
    cart_alphas: np.ndarray     # (ncart, NPRIM)
    cart_coeffs: np.ndarray     # (ncart, NPRIM) includes cartesian primitive norms
    cart_centers: np.ndarray    # (ncart, 3)
    cart_atom: np.ndarray       # (ncart,) int
    c2s: np.ndarray             # (nao, ncart) sparse cart->sph transform
    # --- flat primitive-term table for AO evaluation (row per spherical AO) ---
    term_powers: np.ndarray     # (nao, NTERM, 3) int
    term_alphas: np.ndarray     # (nao, NTERM)
    term_weights: np.ndarray    # (nao, NTERM) zero-padded
    ao_centers: np.ndarray      # (nao, 3)
    ao_atom: np.ndarray         # (nao,) int
    ao_labels: list[str]


def _shell_self_overlap(l: int, alphas, coeffs) -> float:
    """Radial self-overlap of a contraction of radially-normalized prims."""
    s = 0.0
    for ai, ci in zip(alphas, coeffs):
        for aj, cj in zip(alphas, coeffs):
            ni, nj = radial_gto_norm(l, ai), radial_gto_norm(l, aj)
            k = 2 * l + 2
            ov = gamma((k + 1) / 2.0) / (2.0 * (ai + aj) ** ((k + 1) / 2.0))
            s += ci * cj * ni * nj * ov
    return s


def build_basis(mol: Molecule, zeta_override=None) -> BasisSet:
    """zeta_override: {symbol: {shell_name: zeta}} trial exponents (the
    variational optimizer, basis/atomic_scf.py); beats the ZETA tables."""
    # warn once per element when the STO-3G tables for it are not the
    # published (canonical) values -- sub-1e-6 Eh parity with a reference
    # PySCF sto-3g run cannot be guaranteed for such molecules
    import warnings

    from quantum_compute_dft_tpu_torch.basis.data import provenance

    for sym in sorted(set(mol.symbols)):
        if zeta_override and sym in zeta_override:
            continue
        prov = provenance(sym)
        if prov != "canonical":
            warnings.warn(
                f"STO-3G tables for element {sym} are '{prov}' "
                "(physics-anchored, NOT the published values); energies "
                "will differ from reference sto-3g results. Import exact "
                "tables with tools/import_basis.py to fix.",
                RuntimeWarning,
                stacklevel=2,
            )

    shells: list[Shell] = []
    for ia, sym in enumerate(mol.symbols):
        for shell_name, l, alphas, coeffs in element_shells(
            sym, (zeta_override or {}).get(sym)
        ):
            a = np.asarray(alphas, dtype=np.float64)
            c = np.asarray(coeffs, dtype=np.float64)
            c = c / sqrt(_shell_self_overlap(l, a, c))
            shells.append(
                Shell(
                    atom=ia,
                    l=l,
                    center=mol.coords[ia].copy(),
                    alphas=a,
                    coeffs=c,
                    label=f"{sym}{ia} {shell_name}(l={l})",
                )
            )

    # ---- cartesian AO table + c2s ----
    cart_rows = []
    sph_blocks = []   # (nao_block, ncart_block) per shell
    ao_labels: list[str] = []
    ao_atom = []
    ao_centers = []
    for sh in shells:
        monos = CART_MONOMIALS[sh.l]
        # For s/p the solid-harmonic factor is a scalar per component; fold it
        # into the primitive coefficients so c2s is identity there (keeps the
        # ERI cart->sph transform a no-op for d-free molecules).
        fold = sqrt(1.0 / (4.0 * pi)) if sh.l == 0 else (
            sqrt(3.0 / (4.0 * pi)) if sh.l == 1 else 1.0
        )
        for lx, ly, lz in monos:
            # per-primitive coefficient: published coeff * radial norm, expressed
            # against the *unnormalized* cartesian primitive.
            coeffs = np.array(
                [
                    fold * c * radial_gto_norm(sh.l, a)
                    for a, c in zip(sh.alphas, sh.coeffs)
                ]
            )
            cart_rows.append(((lx, ly, lz), sh.alphas, coeffs, sh.center, sh.atom))
        sph_blocks.append(np.eye(2 * sh.l + 1) if sh.l <= 1 else SPH_FROM_CART[sh.l])
        nsph = SPH_FROM_CART[sh.l].shape[0]
        for m in range(nsph):
            ao_labels.append(f"{sh.label} m{m}")
            ao_atom.append(sh.atom)
            ao_centers.append(sh.center)

    ncart = len(cart_rows)
    cart_powers = np.array([r[0] for r in cart_rows], dtype=np.int32)
    cart_alphas = np.array([r[1] for r in cart_rows])
    cart_coeffs = np.array([r[2] for r in cart_rows])
    cart_centers = np.array([r[3] for r in cart_rows])
    cart_atom = np.array([r[4] for r in cart_rows], dtype=np.int32)

    nao = sum(b.shape[0] for b in sph_blocks)
    c2s = np.zeros((nao, ncart))
    io = jo = 0
    for b in sph_blocks:
        ns, nc = b.shape
        c2s[io : io + ns, jo : jo + nc] = b
        io += ns
        jo += nc

    # Spherical AOs are exactly normalized by construction: the contraction
    # is radially renormalized above and the solid-harmonic rows carry the
    # orthonormal-on-the-sphere constants, so <AO_m|AO_m> = 1.

    # ---- flat primitive-term table (row per spherical AO) ----
    # Each spherical AO = sum_k c2s[ao, cart_k] * monomial_k * radial contraction.
    # Expand into primitive terms: weight = c2s * coeff_prim.
    max_terms = 0
    term_rows = []
    for ao in range(nao):
        terms = []
        for cart in np.nonzero(c2s[ao])[0]:
            w_mono = c2s[ao, cart]
            for p in range(NPRIM):
                terms.append(
                    (
                        tuple(cart_powers[cart]),
                        cart_alphas[cart, p],
                        w_mono * cart_coeffs[cart, p],
                    )
                )
        term_rows.append(terms)
        max_terms = max(max_terms, len(terms))

    nterm = max_terms
    term_powers = np.zeros((nao, nterm, 3), dtype=np.int32)
    term_alphas = np.ones((nao, nterm))
    term_weights = np.zeros((nao, nterm))
    for ao, terms in enumerate(term_rows):
        for t, (pw, al, w) in enumerate(terms):
            term_powers[ao, t] = pw
            term_alphas[ao, t] = al
            term_weights[ao, t] = w

    return BasisSet(
        shells=shells,
        nao=nao,
        ncart=ncart,
        cart_powers=cart_powers,
        cart_alphas=cart_alphas,
        cart_coeffs=cart_coeffs,
        cart_centers=cart_centers,
        cart_atom=cart_atom,
        c2s=c2s,
        term_powers=term_powers,
        term_alphas=term_alphas,
        term_weights=term_weights,
        ao_centers=np.array(ao_centers),
        ao_atom=np.array(ao_atom, dtype=np.int32),
        ao_labels=ao_labels,
    )


# aufbau filling order and subshell capacities for the SAD guess
_AUFBAU_ORDER = ["1s", "2s", "2p", "3s", "3p", "4s", "3d", "4p",
                 "5s", "4d", "5p", "6s"]
_SUB_CAP = {"s": 2, "p": 6, "d": 10}


def sad_occupations(basis: BasisSet, z_of_atom, nelec: int) -> np.ndarray:
    """Superposition-of-atomic-densities guess: per-AO occupation numbers
    from aufbau-filled neutral atoms, uniformly scaled to the molecular
    electron count (handles charged systems).

    D0 = diag(occ) satisfies Tr(D0 S) = nelec exactly (normalized AOs),
    and typically halves the SCF iteration count vs the reference's bare
    Hcore guess (ref dft.py:181) -- the converged fixed point is of
    course identical."""
    # per-atom (n, subshell) -> electron count
    def config(z: int) -> dict[str, float]:
        cfg: dict[str, float] = {}
        rem = z
        for sub in _AUFBAU_ORDER:
            take = min(_SUB_CAP[sub[-1]], rem)
            if take:
                cfg[sub] = float(take)
            rem -= take
            if rem == 0:
                break
        return cfg

    occ = np.zeros(basis.nao)
    io = 0
    for sh in basis.shells:
        nfun = 2 * sh.l + 1
        # shell label like "O 2sp(p)": principal n is the first digit of
        # the second token
        name = sh.label.split()[1]
        n = int(name[0])
        sub = f"{n}{'spd'[sh.l]}"
        cfg = config(int(z_of_atom[sh.atom]))
        electrons = cfg.get(sub, 0.0)
        occ[io:io + nfun] = electrons / nfun
        io += nfun
    total = occ.sum()
    if total > 0:
        occ *= nelec / total
    return occ
