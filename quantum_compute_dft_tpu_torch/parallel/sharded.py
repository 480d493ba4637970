"""Grid-sharded XC and sharded J/K builds over a rank group.

Port of ``quantum_compute_dft_tpu/parallel/sharded.py``: the quadrature
grid is sharded over the ranks for the XC, the in-core ERI over its first
AO index, the density-fitting factor over its aux axis; the density and
every (nao, nao) matrix are replicated, and the per-rank partials meet in
one sum (parallel/mesh.py's all_reduce_sum).  O(nao^2) bytes cross the
link per build, whatever the grid or aux size.

Each rank's share runs through the same f64 functions as one device
(engine/xc_engine.py's _xc_scan, the in-core contractions of
engine/coulomb.py, the DF contractions of integrals/density_fitting.py),
so one rank gives the single-device result.  The JAX package's per-shard
XC and J/K are plain f64 einsums too: this path has no TPU kernel.

Density fitting: J = sum_ranks B_loc (B_loc^T . D) and K = sum_ranks
sum_{q local} B_q D B_q^T over the factor B, the Cholesky L itself or, with
a metric v2c, the RI factor B = ri_factor(j3c, v2c) formed before the aux
axis is cut (as the port's make_df_builders does).  The JAX package's
metric branch (a row-sharded V^+ and an all_gather of rho) is not carried
over: the port's RI J is B (B^T D), since the V^+ form departs from it by
7.3e-9 of |J| at the 'tight' tier (ROADMAP.md section 3).
"""

from __future__ import annotations

import torch

from quantum_compute_dft_tpu_torch.engine.xc_engine import _xc_scan
from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
    _auto_k_dtype,
    _cd_coulomb_q,
    _df_exchange,
    _df_exchange_f64,
    ri_factor,
)
from quantum_compute_dft_tpu_torch.parallel.mesh import (
    Shard,
    all_reduce_sum,
    local_block,
)
from quantum_compute_dft_tpu_torch.xc.functionals import Functional


def sharded_xc_step(shard: Shard, functional: Functional):
    """-> f(dm, ao_loc, w_loc, g_loc) -> (E_xc, V_xc), both summed over the
    ranks (g_loc None for functionals without gradients): the rank's rows
    through the f64 engine, then one sum of [E, V_half]."""

    def xc(dm, ao_loc, w_loc, g_loc=None):
        exc, v_half = _xc_scan(functional, dm, ao_loc, w_loc, g_loc,
                               want_v=True)
        n = dm.shape[0]
        buf = all_reduce_sum(shard, torch.cat([exc.reshape(1),
                                               v_half.reshape(-1)]))
        v_half = buf[1:].reshape(n, n)
        return buf[0], 0.5 * (v_half + v_half.T)

    return xc


def _rows(shard: Shard, blk: torch.Tensor, n: int) -> torch.Tensor:
    """A rank's row block placed in a zero (nao_pad, ...) matrix, summed
    over the ranks, cut back to n rows."""
    b = blk.shape[0]
    full = torch.zeros((shard.world * b,) + tuple(blk.shape[1:]),
                       dtype=blk.dtype, device=blk.device)
    full[shard.rank * b:(shard.rank + 1) * b] = blk
    return all_reduce_sum(shard, full)[:n]


def sharded_fock_builders(shard: Shard):
    """-> (coulomb(eri_loc, dm), exchange(eri_loc, dm)) over this rank's ERI
    row block eri_loc (nao_pad / world, nao, nao, nao) (mesh.local_block of
    the ERIs along axis 0): J_ij = sum_kl (ij|kl) D_kl and K_ik = sum_jl
    (ij|kl) D_jl for the local rows i, summed into (nao, nao)."""

    def coulomb(eri_loc, dm):
        n = dm.shape[0]
        b = eri_loc.shape[0]
        j_blk = (eri_loc.reshape(b * n, n * n) @ dm.reshape(-1)).reshape(b, n)
        return _rows(shard, j_blk, n)

    def exchange(eri_loc, dm):
        return _rows(shard, torch.einsum("ijkl,jl->ik", eri_loc, dm),
                     dm.shape[0])

    return coulomb, exchange


def sharded_df_builders(shard: Shard, j3c, v2c, build_k: bool = True,
                        k_dtype: str | None = None):
    """Density-fitted J/K over the aux-sharded factor -> build_jk(dm) ->
    (J, K or None), replicated (nao, nao).

    j3c (nao, nao, naux): a Cholesky factor L (v2c None) or the RI
    3-center integrals with their metric v2c (the factor B is formed
    first).  K in f64 or f32 (k_dtype; default by _auto_k_dtype on the
    whole aux size: f64 up to ~1e12 B-build flops); the f32 K raises
    unless f32 products run in full f32 (_df_exchange).  J and K meet in
    one sum."""
    j3c = torch.as_tensor(j3c)
    if v2c is None:
        b = j3c
    else:
        b = ri_factor(j3c.to(torch.float64),
                      torch.as_tensor(v2c, dtype=torch.float64,
                                      device=j3c.device))[0]
    nao, _, naux = b.shape
    b_loc = local_block(shard, b, 2)                  # (nao, nao, naux_loc)
    del b
    bq_loc = b_loc.permute(2, 0, 1).contiguous()      # aux-major, for J
    if not build_k:
        return lambda dm: (all_reduce_sum(shard, _cd_coulomb_q(bq_loc, dm)),
                           None)
    if k_dtype is None:
        k_dtype = _auto_k_dtype(nao, naux)
    if k_dtype == "float64":
        def k_loc(dm):
            return _df_exchange_f64(b_loc, dm)
    else:
        b_loc = b_loc.to(torch.float32)

        def k_loc(dm):
            return _df_exchange(b_loc, dm)

    def build_jk(dm):
        j, k = all_reduce_sum(shard, torch.stack([_cd_coulomb_q(bq_loc, dm),
                                                  k_loc(dm)]))
        return j, k

    return build_jk
