"""One SCF cycle over a rank group: grid-sharded XC, sharded J/K, then
CDIIS and the eigensolve on every rank.

Port of ``quantum_compute_dft_tpu/parallel/sharded_scf.py``.  The Fock
build shards the in-core ERI over its first AO index or, density-fitted
(the only mode at the north star's size), the factor over its aux axis
(parallel/sharded.py).  Hcore, S, X, the density and the DIIS history are
replicated: the sums give every rank the same bits, and the same inputs
give every rank the same eigh.  The step is the JAX package's: no mixer,
level shift, damping or smearing.
"""

from __future__ import annotations

import torch

from quantum_compute_dft_tpu_torch.parallel.mesh import (
    Shard,
    broadcast,
    local_block,
    shard_grid_arrays,
)
from quantum_compute_dft_tpu_torch.parallel.sharded import (
    sharded_df_builders,
    sharded_fock_builders,
    sharded_xc_step,
)
from quantum_compute_dft_tpu_torch.scf.diis import diis_init, diis_update
from quantum_compute_dft_tpu_torch.scf.driver import SCFSystem, _density
from quantum_compute_dft_tpu_torch.xc.functionals import Functional


def make_sharded_scf(shard: Shard, sys: SCFSystem, functional: Functional):
    """-> (step, dm0, diis0); step(dm, diis) -> (dm_new, diis, e_tot) runs
    one cycle on this rank, in step with the others.

    In-core (sys.eri: cut into AO row blocks) or density-fitted (sys.df_bq,
    the aux-major factor: cut along its aux axis).  Only the rank's shards
    and the (nao, nao) matrices are kept, so the caller may free `sys`.
    The replicated matrices are rank 0's (one broadcast each, here).  dm0
    is the SAD guess when the system has one, else the Hcore guess."""
    if sys.eri is None and sys.df_bq is None:
        raise ValueError(
            "make_sharded_scf needs either in-core ERIs (sys.eri) or the "
            "density-fitting factor (sys.df_bq); kohn_sham.prepare keeps "
            "one of them")
    dev = shard.device
    nao = sys.hcore.shape[0]
    c_hf = functional.hyb_coeff

    def replicated(t):
        return broadcast(shard, t.to(dev, torch.float64, copy=True))

    hcore, s_mat, x_mat = (replicated(t) for t in (sys.hcore, sys.s, sys.x))
    e_nuc, nocc, nopen = sys.e_nuc, sys.nocc, sys.nopen
    ao_loc, w_loc, g_loc = shard_grid_arrays(shard, sys.ao, sys.weights,
                                             sys.ao_grad)
    if sys.eri is not None:
        eri_loc = local_block(shard, sys.eri, 0)
        j_fn, k_fn = sharded_fock_builders(shard)

        def build_jk(dm):
            return j_fn(eri_loc, dm), k_fn(eri_loc, dm) if c_hf != 0.0 else None

    else:
        build_jk = sharded_df_builders(shard, sys.df_bq.permute(1, 2, 0),
                                       None, build_k=c_hf != 0.0)
    xc_fn = sharded_xc_step(shard, functional)

    def step(dm, diis):
        j, k = build_jk(dm)
        e_xc, vxc = xc_fn(dm, ao_loc, w_loc, g_loc)
        f = hcore + j + vxc
        if k is not None:
            f = f - 0.5 * c_hf * k
        diis, f = diis_update(diis, f, dm, s_mat, x_mat)
        dm_new = _density(x_mat, f, nocc, nopen)
        e_tot = torch.sum(dm_new * hcore) + 0.5 * torch.sum(dm_new * j) + e_xc
        if k is not None:
            e_tot = e_tot - 0.25 * c_hf * torch.sum(dm_new * k)
        return dm_new, diis, e_tot + e_nuc

    if sys.dm_sad is not None:
        dm0 = replicated(sys.dm_sad)
    else:
        dm0 = _density(x_mat, hcore, nocc, nopen)
    return step, dm0, diis_init(nao, device=dev)
