"""The port's multi-rank path (quantum_compute_dft_tpu_torch/parallel/)
against the JAX package's parallel/ on its 8-device virtual CPU mesh, and
against the port's single-device functions, on the CPU over gloo.

The ranks are spawned once per group (tests/torch_parallel_ranks.py; no
JAX in them), at world 3, which leaves ragged shards of every axis (H2O's
7 AOs, its grid points, its factor's aux columns), and at world 1; each
group computes every case once.  Inputs: the JAX package's H2O setup
arrays (B3LYP, grid 1 in-core; grid 0 on its Cholesky factor) and the
port's RI 'fast' tensors, with a seeded perturbed SAD density.

Tolerances, as tests/test_parallel.py's: sharded XC and in-core J/K
1e-11, Cholesky DF J/K 1e-10 (sums in another order); the RI tier 2e-9
against the JAX package's single-device builders (its own bar: the JAX
RI J goes through V^+, ROADMAP.md section 3), 1e-11 against the port's;
one SCF step against scf_iteration, energy 5e-9 and density 1e-7 (the
eigensolve amplifies ~1e-11 Fock differences).  Every rank ends with the
same bits, and one rank repeats the single-device arithmetic exactly.
"""

import os
import sys

import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.integrals.density_fitting import (
    make_df_builders as jax_make_df_builders,
)
from quantum_compute_dft_tpu.mol import from_atoms as jax_from_atoms
from quantum_compute_dft_tpu.parallel import grid_mesh
from quantum_compute_dft_tpu.parallel import pad_to_multiple as jax_pad
from quantum_compute_dft_tpu.parallel import shard_grid_arrays as jax_shard
from quantum_compute_dft_tpu.parallel import (
    sharded_df_builders as jax_sharded_df,
)
from quantum_compute_dft_tpu.parallel import (
    sharded_fock_builders as jax_sharded_fock,
)
from quantum_compute_dft_tpu.parallel import sharded_xc_step as jax_sharded_xc
from quantum_compute_dft_tpu.xc import FUNCTIONALS as JAX_FUNCTIONALS
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.engine.coulomb import (
    coulomb_full,
    exchange_full,
)
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
from quantum_compute_dft_tpu_torch.integrals.density_fitting import (
    _cd_coulomb_q,
    _df_exchange_f64,
    df_tensors,
    make_df_builders,
    ri_factor,
)
from quantum_compute_dft_tpu_torch.mol import from_atoms
from quantum_compute_dft_tpu_torch.parallel import pad_to_multiple
from quantum_compute_dft_tpu_torch.parallel.launch import run_ranks
from quantum_compute_dft_tpu_torch.parallel.mesh import Shard
from quantum_compute_dft_tpu_torch.parallel.sharded_scf import make_sharded_scf
from quantum_compute_dft_tpu_torch.scf.diis import diis_init
from quantum_compute_dft_tpu_torch.scf.driver import (
    initial_guess,
    scf_iteration,
)
from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import torch_northstar_mesh as mesh_tool  # noqa: E402

torch.set_num_threads(1)

H2O = [("O", (0.0, 0.0, 0.127)), ("H", (0.0, 0.758, -0.509)),
       ("H", (0.0, -0.758, -0.509))]
STEPS = 2    # SCF cycles each group runs on each system


def _arrays(setup, rng) -> dict:
    s = setup.sys
    n = setup.nao
    pert = rng.standard_normal((n, n)) * 1e-2
    out = {k: None if getattr(s, k) is None else np.array(getattr(s, k))
           for k in ("hcore", "s", "eri", "ao", "ao_grad", "weights",
                     "dm_sad")}
    out.update(e_nuc=float(s.e_nuc), nocc=int(s.nocc), nopen=int(s.nopen),
               sad_occ=np.diag(out.pop("dm_sad")),
               dm=np.diag(np.diag(np.asarray(s.dm_sad))) + pert + pert.T)
    return out


@pytest.fixture(scope="module")
def inputs():
    """(in-core arrays, Cholesky DF arrays with l_vec, RI j3c/v2c)."""
    rng = np.random.default_rng(11)
    incore = _arrays(jax_kohn_sham.prepare(jax_from_atoms(H2O), "B3LYP",
                                           grid_level=1), rng)
    s_df = jax_kohn_sham.prepare(jax_from_atoms(H2O), "B3LYP", grid_level=0,
                                 density_fit=True)
    dfsys = _arrays(s_df, rng)
    dfsys["l_vec"] = np.asarray(s_df.sys.df_j3c)
    assert s_df.sys.df_v2c is None and dfsys["eri"] is None
    mol = from_atoms(H2O)
    j3c, v2c = df_tensors(build_basis(mol), mol, aux_level="fast")
    return incore, dfsys, {"j3c": j3c.numpy(), "v2c": v2c.numpy()}


def _group(inputs, world):
    return run_ranks(ranks.builders_and_steps, world, "gloo", "cpu", *inputs,
                     STEPS)


@pytest.fixture(scope="module")
def world3(inputs):
    return _group(inputs, 3)


@pytest.fixture(scope="module")
def world1(inputs):
    return _group(inputs, 1)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _maxdiff(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("name", ["B3LYP", "LDA"])
def test_sharded_xc(inputs, world3, name):
    """B3LYP with gradient planes, LDA without: the JAX package's
    sharded_xc_step and the port's xc_step."""
    a = inputs[0]
    grad = a["ao_grad"] if name == "B3LYP" else None
    mesh = grid_mesh()
    ao_s, w_s, g_s = jax_shard(mesh, a["ao"], a["weights"], grad)
    e_jax, v_jax = jax_sharded_xc(mesh, JAX_FUNCTIONALS[name])(
        a["dm"], ao_s, w_s, g_s)
    e_one, v_one = xc_step(FUNCTIONALS[name], _t(a["dm"]), _t(a["ao"]),
                           _t(a["weights"]), _t(grad))
    # the JAX package's V_xc has half the sigma term (jax_potential)
    e, v = world3[0][f"xc_{name}_half"]
    assert abs(e - float(e_jax)) < 1e-11 and _maxdiff(v, v_jax) < 1e-11
    e, v = world3[0][f"xc_{name}"]
    assert abs(e - float(e_one)) < 1e-11 and _maxdiff(v, v_one) < 1e-11


def test_sharded_jk_incore(inputs, world3):
    a = inputs[0]
    mesh = grid_mesh()
    nao = a["dm"].shape[0]
    eri_s = jax_pad(a["eri"], 8, 0)
    assert np.array_equal(pad_to_multiple(a["eri"], 8, 0), eri_s)
    import jax

    eri_s = jax.device_put(eri_s, NamedSharding(mesh, P("grid", None, None,
                                                        None)))
    jfn, kfn = jax_sharded_fock(mesh)
    j, k = world3[0]["jk_incore"]
    assert _maxdiff(j, jfn(eri_s, a["dm"])[:nao]) < 1e-11
    assert _maxdiff(k, kfn(eri_s, a["dm"])[:nao]) < 1e-11


def test_sharded_df_cholesky(inputs, world3):
    d = inputs[1]
    j_ref, k_ref = jax_sharded_df(grid_mesh(), d["l_vec"], None)(d["dm"])
    j, k = world3[0]["jk_cd"]
    assert _maxdiff(j, j_ref) < 1e-10 and _maxdiff(k, k_ref) < 1e-10


def test_sharded_ri_fast_tier(inputs, world3):
    a, _, ri = inputs
    jf, kf, _ = jax_make_df_builders(ri["j3c"], ri["v2c"])
    j, k = world3[0]["jk_ri"]
    assert _maxdiff(j, jf(a["dm"])) < 2e-9 and _maxdiff(k, kf(a["dm"])) < 2e-9
    jp, kp, _ = make_df_builders(_t(ri["j3c"]), _t(ri["v2c"]))
    dm = _t(a["dm"])
    assert _maxdiff(j, jp(dm)) < 1e-11 and _maxdiff(k, kp(dm)) < 1e-11


def _single(arrays, df_l=None):
    return ranks._setup(arrays, "B3LYP", df_l)


@pytest.mark.parametrize("key", ["incore", "cd"])
def test_sharded_scf_step(inputs, world3, key):
    """make_sharded_scf's first step against the port's scf_iteration from
    the same SAD density."""
    arrays = inputs[0] if key == "incore" else inputs[1]
    ks = _single(arrays, arrays.get("l_vec"))
    dm0 = initial_guess(ks.sys)
    rows = world3[0][f"scf_{key}"]
    assert _maxdiff(rows[0], dm0) < 1e-14
    dm1, _, en, _ = scf_iteration(ks.sys, ks.functional, dm0,
                                  diis_init(ks.nao))
    dm_sh, e_sh = rows[1]
    assert abs(e_sh - float(en[0])) < 5e-9
    assert _maxdiff(dm_sh, dm1) < 1e-7


def test_sharded_requires_eri_or_df(inputs):
    import dataclasses

    ks = _single(inputs[1], inputs[1]["l_vec"])
    bad = dataclasses.replace(ks.sys, df_bq=None, df_bq32=None, df_l=None)
    with pytest.raises(ValueError, match="in-core ERIs"):
        make_sharded_scf(Shard(0, 1, None, torch.device("cpu")), bad,
                         ks.functional)


def _leaves(res):
    """Every array and number of one rank's result, in a fixed order."""
    out = []
    for key in sorted(res):
        val = res[key]
        stack = [val]
        while stack:
            v = stack.pop()
            if isinstance(v, (tuple, list)):
                stack.extend(reversed(v))
            else:
                out.append((key, np.asarray(v)))
    return out


def test_ranks_hold_the_same_bits(world3):
    """Every rank's sums, densities and energies equal rank 0's bit for
    bit; replica_spread (broadcast, then a MAX all_reduce) says so too."""
    ref = _leaves(world3[0])
    for res in world3[1:]:
        for (k0, a0), (k, a) in zip(ref, _leaves(res)):
            assert k == k0 and np.array_equal(a, a0), k
    for res in world3:
        assert res["spread_incore"] == 0.0 and res["spread_cd"] == 0.0


def test_world1_is_the_single_device_path(inputs, world1):
    """One rank runs the single-device arithmetic: XC, J/K and STEPS SCF
    cycles equal xc_step, coulomb_full/exchange_full, the DF builders and
    scf_iteration bit for bit."""
    a, d, ri = inputs
    res = world1[0]
    dm = _t(a["dm"])
    for name, grad in (("B3LYP", a["ao_grad"]), ("LDA", None)):
        e, v = xc_step(FUNCTIONALS[name], dm, _t(a["ao"]), _t(a["weights"]),
                       _t(grad))
        assert res[f"xc_{name}"][0] == float(e)
        assert np.array_equal(res[f"xc_{name}"][1], v.numpy())
    eri = _t(a["eri"])
    for got, ref in zip(res["jk_incore"], (coulomb_full(eri, dm),
                                           exchange_full(eri, dm))):
        assert np.array_equal(got, ref.numpy())
    b_ri = ri_factor(_t(ri["j3c"]), _t(ri["v2c"]))[0]
    for key, b, dmx in (("jk_cd", _t(d["l_vec"]), _t(d["dm"])),
                        ("jk_ri", b_ri, dm)):
        # the SCF's DF J (aux-major factor) and f64 K
        j = _cd_coulomb_q(b.permute(2, 0, 1).contiguous(), dmx)
        assert np.array_equal(res[key][0], j.numpy()), key
        assert np.array_equal(res[key][1], _df_exchange_f64(b, dmx).numpy()), key
    for key, arrays in (("incore", a), ("cd", d)):
        ks = _single(arrays, arrays.get("l_vec"))
        dmx, diis = initial_guess(ks.sys), diis_init(ks.nao)
        for dm_sh, e_sh in res[f"scf_{key}"][1:]:
            dmx, diis, en, _ = scf_iteration(ks.sys, ks.functional, dmx, diis)
            assert np.array_equal(dm_sh, dmx.numpy()), key
            assert e_sh == float(en[0]), key


def _tool_run(tmp_path, monkeypatch, world, **kw):
    # one thread per rank (the tool's ranks take torch's default)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = mesh_tool.config("H2O", grid_level=1, cd_tol=1e-7,
                           factor_dir=str(tmp_path), **kw)
    return mesh_tool.run(cfg, world, "gloo", "cpu")


def test_mesh_tool_parity_and_builders(tmp_path, monkeypatch):
    """tools/torch_northstar_mesh.py on H2O/B3LYP grid 1 (Cholesky DF) at
    world 2: the factor built by rank 0 and loaded by rank 1, the sharded
    builders within 1e-11 of one device, 3 parity cycles within the JAX
    tool's rule, and a one-cycle dryrun."""
    out = _tool_run(tmp_path, monkeypatch, 2, modes=("builders", "parity", "converge"),
                    cycles=3, max_cycle=1)
    assert mesh_tool.failures(out) == []
    assert [s["factor_cached"] for s in out["setup_by_rank"]] == [False, True]
    assert len(out["parity_rows"]) == 3 and out["cycles"] == 1
    assert out["cd_rank"] > out["nao"] and out["launches"]["K1"] == 0


@pytest.mark.slow
def test_mesh_tool_converges(tmp_path, monkeypatch):
    """The sharded loop at world 3 to |dE| < 1e-8 and ||dD|| < 1e-9, within
    5e-9 Eh of scf_host(xc_impl="f64", conv_tol_d=1e-9) on the same setup
    (the JAX file's bars)."""
    out = _tool_run(tmp_path, monkeypatch, 3, modes=("converge",), d_tol=1e-9,
                    reference=True)
    ref = out["reference"]
    assert mesh_tool.failures(out) == [] and ref["converged"]
    assert abs(ref["dE_mesh"]) < 5e-9
