"""Density-fitted Coulomb and exchange over a Cholesky factor, torch.

Port of the identity-metric (pivoted-Cholesky, ``df_aux='parity'``) part of
``quantum_compute_dft_tpu/integrals/density_fitting.py``.  The factor L
(nao, nao, naux) of W ~= L L^T (integrals/cholesky.py) is used directly,
with no fitting metric:

    J = sum_Q L_Q (L_Q . D),    K = sum_Q L_Q D L_Q^T.

Two layouts, as in the JAX package: the (nao, nao, naux) factor for the f64
K, and an aux-major (naux, nao, nao) copy that turns J into two
(naux, nao^2) matrix-vector products and the f32 K into two large matrix
products.  These are plain large products that the JAX package leaves to
XLA; here they are ``torch.matmul``.  The f32 builders stand for
``Precision.HIGHEST``: they refuse to run with TF32 enabled.

The RI auxiliary tiers (``df_tensors``, ``metric_factors``, ``'tight'`` /
``'fast'``) are not ported yet.
"""

from __future__ import annotations

import torch


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
    """-> (coulomb(dm) -> J, exchange(dm) -> K | None, B | None) from a
    Cholesky factor j3c = L (nao, nao, naux) with v2c=None (identity
    metric).  K's factor is L itself, in f64 or f32 (k_dtype, default by
    _auto_k_dtype)."""
    if v2c is not None:
        raise NotImplementedError(
            "density fitting with an auxiliary-basis metric (df_aux "
            "'tight'/'fast') is not ported yet; only the Cholesky factor "
            "(df_aux='parity', v2c=None)")
    l_vec = j3c

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
