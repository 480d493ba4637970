"""Density-fitted Coulomb and exchange, torch.

Port of ``quantum_compute_dft_tpu/integrals/density_fitting.py``: the
auxiliary-basis (RI) tiers 'tight' and 'fast' and the identity-metric
(pivoted-Cholesky, ``df_aux='parity'``) factor, all reduced to one factor B
(nao, nao, naux) with the ERIs approximated as W ~= B B^T:

    J = sum_Q B_Q (B_Q . D),    K = sum_Q B_Q D B_Q^T.

*Cholesky.* B is the factor L of integrals/cholesky.py itself.

*RI.* An even-tempered auxiliary basis is generated per element from the
orbital basis (``autoaux_exponents``; exponents spanning the products of
orbital primitives, angular momenta past the occupied ones).  The 3-center
(munu|P) and 2-center (P|Q) integrals reuse the 4-center McMurchie-Davidson
stages of integrals/two_electron.py with a zero-exponent s dummy as the
second ket function: exp(-0 r^2) = 1 turns (munu|P s_dummy) into (munu|P).
The metric V = (P|Q) is factorized by an f64 eigh on the integrals' device
(the JAX package moves it to the host only because the TPU's f64 eigh is
f32-quality), keeping the directions with w > METRIC_LINDEP w_max, and

    B = j3c U_k w_k^(-1/2),   B B^T = j3c V^+ j3c^T   (exactly, on the kept
                                                        space),

so the RI factor enters the SCF as the Cholesky factor does, and J and K
reuse its machinery.  The JAX package instead forms J by the robust fit
j3c V^+ (j3c^T D), which is the same matrix in another order
(tests/test_torch_ri.py holds the two together), and keeps the square
B = j3c V^(-1/2), whose extra columns are a rotation of these (B_sq =
B U_k^T): K is the same.  The kernel phase of the 'fast' schedule then runs
the RI K in f32 (the aux-major f32 copy of B) where the JAX package's
``_auto_k_dtype`` would keep it f64 up to ~1e12 build flops; the f64 verify
cycles and the reported ``energy_of_dm`` use the f64 B, so the reported
energy does not depend on it.

Two layouts, as in the JAX package: the (nao, nao, naux) factor for the f64
K, and an aux-major (naux, nao, nao) copy that turns J into two
(naux, nao^2) matrix-vector products and the f32 K into two large matrix
products.  These are plain large products that the JAX package leaves to
XLA; here they are ``torch.matmul``.  The f32 builders stand for
``Precision.HIGHEST``: they refuse to run with TF32 enabled.
"""

from __future__ import annotations

import time
from math import pi, sqrt

import numpy as np
import torch
from torch.func import vmap

from quantum_compute_dft_tpu_torch.basis.basis_set import (
    CART_MONOMIALS,
    NPRIM,
    SPH_FROM_CART,
    BasisSet,
    radial_gto_norm,
)
from quantum_compute_dft_tpu_torch.basis.data import element_shells
from quantum_compute_dft_tpu_torch.integrals.mcmurchie import hermite_combos
from quantum_compute_dft_tpu_torch.integrals.two_electron import (
    _pair_stage,
    _quartet_kernel,
    pair_data,
)
from quantum_compute_dft_tpu_torch.mol.molecule import Molecule

# Named auxiliary-basis accuracy tiers (the JAX package's, measured there on
# H2O B3LYP DF-SCF against in-core, grid level 1):
#   'tight': |dE| ~ 6e-8 Eh on H2O (g functions on p-block atoms, graded
#            taper, lindep 1e-9); the error grows with system size (~1e-5
#            on benzene) and the metric turns ill-conditioned, so the
#            guaranteed-accuracy path is the Cholesky factor ('parity').
#   'fast':  |dE| ~ 2e-5 Eh at ~40% of the aux size / 3c-build cost.
# Both errors grow with size: at DHA (nao 152, B3LYP grid 3) the port's
# 'tight' lands -9.1e-6 Eh and 'fast' -1.06e-4 Eh from the Cholesky
# factor's energy (H100, chip_smoke.py phase 4d).
AUX_LEVELS = {
    "tight": dict(beta=1.6, taper=2, l_extra=3),
    "fast": dict(beta=2.0, taper=2, l_extra=2),
}

# metric directions with eigenvalue <= METRIC_LINDEP * w_max are dropped
# (the JAX package's metric_factors default, measured best there: 1e-10
# keeps noise directions that stall the SCF, 1e-8 drops useful ones)
METRIC_LINDEP = 1e-9

# elements of one (bra pair, aux, bra primitive, Hermite sum) slab of the
# quartet kernel: sets the (bra block x aux block) tile of the 3-center and
# 2-center loops (the Hermite sums run to 165 terms with d shells and g
# aux functions; the recursion keeps a few hundred such planes)
RI_TILE_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 27}


def autoaux_exponents(mol: Molecule, beta: float = 2.0, lo_f: float = 1.6,
                      hi_f: float = 2.2, taper: int = 2, l_extra: int = 2):
    """Even-tempered auxiliary exponents per element: spans the products of
    orbital-basis primitives.  -> {symbol: [(l, alpha), ...]}

    beta: geometric ratio; lo_f/hi_f: span [lo_f*amin, hi_f*amax] over the
    orbital primitives; taper: tight exponents dropped per l beyond l_occ;
    l_extra: angular momenta past l_occ (captures off-center bond-density
    products that atom-centered lower-l sets fit poorly)."""
    out = {}
    for sym in set(mol.symbols):
        shells = element_shells(sym)
        l_occ = max(s[1] for s in shells)
        amin = min(min(s[2]) for s in shells)
        amax = max(max(s[2]) for s in shells)
        lo, hi = lo_f * amin, hi_f * amax
        n = max(int(np.ceil(np.log(hi / lo) / np.log(beta))) + 1, 2)
        exps = lo * beta ** np.arange(n)
        funcs = []
        for l in range(min(l_occ + l_extra + 1, 5)):
            # graded taper: each l beyond l_occ drops `taper` more of the
            # tightest exponents (high-l fit functions matter most in the
            # valence/bond region, not at the core cusp)
            sel = exps if l <= l_occ else exps[: max(n - taper * (l - l_occ), 1)]
            funcs.extend((l, float(a)) for a in sel)
        out[sym] = funcs
    return out


def build_aux_cart_table(mol: Molecule, beta: float = 2.0, **aux_kw):
    """Cartesian aux-function table (one normalized primitive each):
    -> (powers (naux_cart,3), alphas (naux_cart,), coeffs, centers, c2s_aux)."""
    table = autoaux_exponents(mol, beta, **aux_kw)
    powers, alphas, coeffs, centers = [], [], [], []
    sph_blocks = []
    for ia, sym in enumerate(mol.symbols):
        for l, a in table[sym]:
            fold = sqrt(1.0 / (4.0 * pi)) if l == 0 else (
                sqrt(3.0 / (4.0 * pi)) if l == 1 else 1.0
            )
            for lx, ly, lz in CART_MONOMIALS[l]:
                powers.append((lx, ly, lz))
                alphas.append(a)
                # radially-normalized primitive, with the s/p solid-harmonic
                # scalar folded in (mirrors build_basis)
                coeffs.append(fold * radial_gto_norm(l, a))
                centers.append(mol.coords[ia])
            sph_blocks.append(
                np.eye(2 * l + 1) if l <= 1 else SPH_FROM_CART[l]
            )
    ncart = len(powers)
    nsph = sum(b.shape[0] for b in sph_blocks)
    c2s = np.zeros((nsph, ncart))
    io = jo = 0
    for b in sph_blocks:
        ns, nc = b.shape
        c2s[io : io + ns, jo : jo + nc] = b
        io += ns
        jo += nc
    return (
        np.array(powers, dtype=np.int32),
        np.array(alphas),
        np.array(coeffs),
        np.array(centers),
        c2s,
    )


def synced_time(device: torch.device) -> float:
    """time.time() once the device's queued work has finished."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def _aux_pair_data(l_aux: int, powers, alphas, coeffs, centers, device):
    """Hermite pair data for (aux, dummy) pairs: one primitive slot per aux
    function (the quartet kernel broadcasts over unequal primitive counts
    of bra and ket).  The dummy is an s function of exponent 0 on the aux
    function's own center, so every exponent sum is the aux exponent."""
    f64 = torch.float64
    pair_fn = _pair_stage(l_aux, 0)
    pw = torch.as_tensor(powers.astype(np.int64), device=device)
    al = torch.as_tensor(alphas, dtype=f64, device=device)
    ce = torch.as_tensor(centers, dtype=f64, device=device)
    zero_pow = torch.zeros(3, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=f64, device=device)
    p, P, et = vmap(lambda pa, A, a: pair_fn(pa, zero_pow, A, A, a, zero))(
        pw, ce, al)
    return (p[:, None], P[:, None, :], et[:, None, :],
            torch.as_tensor(coeffs, dtype=f64, device=device)[:, None])


def _tile(nprim: int, l_sum: int, device) -> int:
    """Side of a square (bra block x ket block) tile whose quartet slab
    (pairs x pairs x primitive pairs x Hermite sums) holds about
    RI_TILE_ELEMS[device type] elements."""
    budget = RI_TILE_ELEMS["cuda" if torch.device(device).type == "cuda"
                           else "cpu"]
    return max(16, int(sqrt(budget / (nprim * len(hermite_combos(l_sum))))))


def df_tensors(basis: BasisSet, mol: Molecule, aux_level: str = "tight",
               device="cpu", timings: dict | None = None):
    """-> (j3c (nao, nao, naux_sph), v2c (naux_sph, naux_sph)), f64 tensors
    on `device`.

    aux_level names the accuracy tier of AUX_LEVELS.  The integrals run on
    `device`, in (bra pair block x aux block) tiles sized by RI_TILE_ELEMS;
    no padding rows (eager torch takes any tile shape).  timings, if given,
    receives the seconds of the 3-center and 2-center loops and of the
    cart->sph transform (j3c_s, v2c_s, c2s_s)."""
    device = torch.device(device)
    f64 = torch.float64
    t0 = synced_time(device)
    lmax_ao = int(basis.cart_powers.max())
    apow, aalpha, acoef, acent, ac2s = build_aux_cart_table(
        mol, **AUX_LEVELS[aux_level])
    l_aux = int(apow.sum(axis=1).max())

    # --- AO pair stage (eri_packed's) and aux pair stage ---
    iu, ju, p_ao, P_ao, et_ao, cw = pair_data(basis, device)
    p_ax, P_ax, et_ax, cw_ax = _aux_pair_data(l_aux, apow, aalpha, acoef,
                                              acent, device)
    npair, naux_c = len(iu), len(aalpha)

    # --- 3-center (ij|P) over the unique AO pairs ---
    quartet = _quartet_kernel(2 * lmax_ao, device, l_aux)
    blk = _tile(NPRIM * NPRIM, 2 * lmax_ao + l_aux, device)
    j3c_pair = torch.empty((npair, naux_c), dtype=f64, device=device)
    for s in range(0, npair, blk):
        e = s + blk
        for sa in range(0, naux_c, blk):
            ea = sa + blk
            j3c_pair[s:e, sa:ea] = quartet(
                p_ao[s:e], P_ao[s:e], et_ao[s:e], cw[s:e],
                p_ax[sa:ea], P_ax[sa:ea], et_ax[sa:ea], cw_ax[sa:ea])
    t1 = synced_time(device)

    # --- 2-center (P|Q), upper blocks mirrored ---
    quartet_aux = _quartet_kernel(l_aux, device, l_aux)
    blk = _tile(1, 2 * l_aux, device)
    v2c_c = torch.empty((naux_c, naux_c), dtype=f64, device=device)
    for s in range(0, naux_c, blk):
        e = s + blk
        for sa in range(s, naux_c, blk):
            ea = sa + blk
            b = quartet_aux(p_ax[s:e], P_ax[s:e], et_ax[s:e], cw_ax[s:e],
                            p_ax[sa:ea], P_ax[sa:ea], et_ax[sa:ea],
                            cw_ax[sa:ea])
            v2c_c[s:e, sa:ea] = b
            if sa != s:
                v2c_c[sa:ea, s:e] = b.T
    del p_ao, P_ao, et_ao, cw
    t2 = synced_time(device)

    # unpack AO pairs -> full (n, n, naux_c), then cart->sph on both sides
    n = basis.ncart
    nao = basis.nao
    j3c = torch.zeros((n, n, naux_c), dtype=f64, device=device)
    ii = torch.as_tensor(iu, device=device)
    jj = torch.as_tensor(ju, device=device)
    j3c[ii, jj] = j3c_pair
    j3c[jj, ii] = j3c_pair
    del j3c_pair
    c2s = basis.c2s
    if c2s.shape[0] != n or not np.allclose(c2s, np.eye(n)):
        # c2s is (nao_sph, ncart): rows select cartesian combinations
        c = torch.as_tensor(c2s, dtype=f64, device=device)
        j3c = torch.einsum("ip,pqx->iqx", c, j3c)
        j3c = torch.einsum("jq,iqx->ijx", c, j3c)
    naux = ac2s.shape[0]
    if naux != naux_c or not np.allclose(ac2s, np.eye(naux_c)):
        a = torch.as_tensor(ac2s, dtype=f64, device=device)
        j3c = (j3c.reshape(nao * nao, naux_c) @ a.T).reshape(nao, nao, naux)
        v2c = a @ v2c_c @ a.T
    else:
        v2c = v2c_c
    if timings is not None:
        timings.update(j3c_s=t1 - t0, v2c_s=t2 - t1,
                       c2s_s=synced_time(device) - t2)
    return j3c, v2c


def metric_factors(v2c):
    """Factor of the fitting metric's pseudo-inverse: -> (X (naux, nkeep),
    nkeep) with X X^T = V^+ over the eigen-directions
    w > METRIC_LINDEP * w_max (f64 eigh on v2c's device;
    X = U_k w_k^(-1/2)).  The JAX package's metric_factors returns V^+ and
    V^(-1/2) = X U_k^T; the port forms neither, since J and K both come
    from B = j3c X."""
    w, v = torch.linalg.eigh(v2c)
    keep = w > METRIC_LINDEP * w.max()
    return v[:, keep] / torch.sqrt(w[keep]), int(keep.sum())


def ri_factor(j3c, v2c):
    """-> (B (nao, nao, nkeep), nkeep): the RI factor B = j3c X, with
    B B^T = j3c V^+ j3c^T (see metric_factors), in j3c's dtype and
    device."""
    x, nkeep = metric_factors(v2c)
    nao, _, naux = j3c.shape
    return (j3c.reshape(nao * nao, naux) @ x).reshape(nao, nao, nkeep), nkeep


def _auto_k_dtype(nao: int, naux: int) -> str:
    """The JAX package's rule: an f64 K factor below ~1e12 B-build flops
    (nao^2 naux^2), f32 above."""
    return "float64" if float(nao) ** 2 * float(naux) ** 2 <= 1e12 else "float32"


def _require_full_f32():
    """The f32 builders stand for the JAX package's Precision.HIGHEST:
    TF32 would cut their products to ~10 mantissa bits."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the f32 density-fitting builders need full f32 matrix products: "
            "set torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def make_df_builders(j3c, v2c, build_k: bool = True,
                     k_dtype: str | None = None):
    """-> (coulomb(dm) -> J, exchange(dm) -> K | None, B | None).

    v2c=None: j3c is a Cholesky factor L (nao, nao, naux) with an identity
    metric, and B = L.  Otherwise j3c holds the RI 3-center integrals and
    v2c their metric, and B = ri_factor(j3c, v2c).  J = B (B^T . D); K
    over B in f64 or f32 (k_dtype, default by _auto_k_dtype)."""
    l_vec = j3c if v2c is None else ri_factor(j3c, v2c)[0]

    def coulomb(dm):
        return _cd_coulomb(l_vec, dm)

    if not build_k:
        return coulomb, None, None
    nao, _, naux = l_vec.shape
    if k_dtype is None:
        k_dtype = _auto_k_dtype(nao, naux)
    if k_dtype == "float64":
        def exchange(dm):
            return _df_exchange_f64(l_vec, dm)

        return coulomb, exchange, l_vec
    b32 = l_vec.to(torch.float32)

    def exchange(dm):
        return _df_exchange(b32, dm)

    return coulomb, exchange, b32


def _cd_coulomb(l_vec, dm):
    """J from Cholesky vectors (identity metric)."""
    rho = torch.einsum("ijq,ij->q", l_vec, dm)
    return torch.einsum("ijq,q->ij", l_vec, rho)


def _cd_coulomb_q(bq, dm):
    """J from an aux-major (naux, nao, nao) factor, in the factor's dtype
    (f64 for the 'fast' schedule's J): two (naux, nao^2) matrix-vector
    products."""
    naux, nao, _ = bq.shape
    bflat = bq.reshape(naux, nao * nao)
    rho = bflat @ dm.reshape(-1)
    return (rho @ bflat).reshape(nao, nao)


def _cd_coulomb_f32(bq32, dm):
    """J from the f32 aux-major factor in full f32 (~1e-7 relative)."""
    _require_full_f32()
    naux, nao, _ = bq32.shape
    bflat = bq32.reshape(naux, nao * nao)
    rho = bflat @ dm.to(torch.float32).reshape(-1)
    return (rho @ bflat).reshape(nao, nao).to(dm.dtype)


def _df_exchange_fast(bq32, dm):
    """K over the f32 aux-major factor in full f32 (~1e-6 relative): the
    half-transform is one (naux nao, nao) x (nao, nao) product and the
    pairing step one contraction over (aux, l)."""
    _require_full_f32()
    naux, nao, _ = bq32.shape
    t = (bq32.reshape(naux * nao, nao) @ dm.to(torch.float32)).reshape(
        naux, nao, nao)
    # K_ij = sum_ql t[q,i,l] b[q,j,l]
    return torch.tensordot(t, bq32, dims=([0, 2], [0, 2])).to(dm.dtype)


def make_fast_cd_builders(b, build_k: bool = True):
    """Fast-phase (coulomb, exchange | None, bq32) over a Cholesky factor
    `b` (nao, nao, naux): builds the aux-major f32 copy once."""
    bq32 = b.to(torch.float32).permute(2, 0, 1).contiguous()

    def coulomb(dm):
        return _cd_coulomb_f32(bq32, dm)

    if not build_k:
        return coulomb, None, bq32

    def exchange(dm):
        return _df_exchange_fast(bq32, dm)

    return coulomb, exchange, bq32


def _df_exchange_f64(b, dm):
    """K_ij = sum_q (B_q D B_q^T)_ij, D contracted directly between the
    factors (exact for any symmetric D; no eigh)."""
    t = torch.einsum("ikq,kl->ilq", b, dm)
    return torch.einsum("ilq,jlq->ij", t, b)


def _df_exchange(b32, dm):
    """The f32 form of _df_exchange_f64 (the (nao, nao, naux) layout)."""
    _require_full_f32()
    dm32 = dm.to(torch.float32)
    t = torch.einsum("ikq,kl->ilq", b32, dm32)
    return torch.einsum("ilq,jlq->ij", t, b32).to(dm.dtype)
