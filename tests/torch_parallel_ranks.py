"""Rank functions of tests/test_torch_parallel.py.

Spawned ranks import this module anew, so it imports no JAX: each function
takes numpy inputs (the JAX package's setup arrays, handed over by the
test) and returns numpy results.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.parallel import (
    shard_grid_arrays,
    sharded_df_builders,
    sharded_fock_builders,
    sharded_xc_step,
)
from quantum_compute_dft_tpu_torch.parallel.mesh import local_block, replica_spread
from quantum_compute_dft_tpu_torch.parallel.sharded_scf import make_sharded_scf
from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS


def _setup(arrays: dict, functional: str, df_l=None):
    a = arrays
    return kohn_sham.setup_from_arrays(
        a["hcore"], a["s"], None if df_l is not None else a["eri"], a["ao"],
        a["ao_grad"], a["weights"], a["e_nuc"], a["nocc"], a["nopen"],
        a["sad_occ"], functional, device="cpu", df_l=df_l)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def builders_and_steps(shard, incore: dict, dfsys: dict, ri: dict,
                       steps: int) -> dict:
    """Every sharded builder at the test's density, and `steps` cycles of
    make_sharded_scf on the in-core and the Cholesky DF system."""
    torch.set_num_threads(1)
    out = {}
    dm = torch.as_tensor(incore["dm"])
    ao, w, g = shard_grid_arrays(shard, incore["ao"], incore["weights"],
                                 incore["ao_grad"])
    for name, grad in (("B3LYP", g), ("LDA", None)):
        e, v = sharded_xc_step(shard, FUNCTIONALS[name])(dm, ao, w, grad)
        out[f"xc_{name}"] = (float(e), _np(v))
        # the JAX package's V_xc, for the comparison with its sharded XC
        e, v = sharded_xc_step(shard, FUNCTIONALS[name].jax_potential())(
            dm, ao, w, grad)
        out[f"xc_{name}_half"] = (float(e), _np(v))
    j_fn, k_fn = sharded_fock_builders(shard)
    eri_loc = local_block(shard, incore["eri"], 0)
    out["jk_incore"] = (_np(j_fn(eri_loc, dm)), _np(k_fn(eri_loc, dm)))
    dm_df = torch.as_tensor(dfsys["dm"])
    j, k = sharded_df_builders(shard, dfsys["l_vec"], None)(dm_df)
    out["jk_cd"] = (_np(j), _np(k))
    j, k = sharded_df_builders(shard, ri["j3c"], ri["v2c"])(dm)
    out["jk_ri"] = (_np(j), _np(k))

    for key, arrays, df_l in (("incore", incore, None),
                              ("cd", dfsys, dfsys["l_vec"])):
        ks = _setup(arrays, "B3LYP", df_l)
        step, d, diis = make_sharded_scf(shard, ks.sys, ks.functional)
        rows = [_np(d)]
        for _ in range(steps):
            d, diis, e = step(d, diis)
            rows.append((_np(d), float(e)))
        out[f"scf_{key}"] = rows
        out[f"spread_{key}"] = replica_spread(shard, d)
    return out
