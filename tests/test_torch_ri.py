"""The port's RI auxiliary tiers and the external-factor hook against the
JAX package, on the CPU.

Tolerances and why:
  * the aux table: identical (the same numpy code and element tables);
  * j3c and v2c: 1e-11 of their largest magnitude (the same McMurchie-
    Davidson recursions and Boys function in another operation order;
    measured ~1e-15 on H2O);
  * the kept metric rank: equal, on the JAX package's metric and on the
    port's own (the same eigenvalue rule on matrices equal to ~1e-15);
    X^T V X = I on the kept space to 1e-6 (the tight tier's metric has
    condition ~1e9 there: measured 5.5e-8);
  * J and K on the same (JAX) tensors: K 1e-11 of its largest magnitude
    (both over a factor j3c V^(-1/2) or its rotation; measured 2e-12); J
    1e-11 against J = B (B^T D) over the JAX package's own K factor B
    (measured 5e-13 to 2e-12), and against its robust fit j3c V^+ (j3c^T D)
    1e-8 at fast and 1e-7 at tight: forming V^+ (entries to 4.4e5 at
    tight, condition ~1e9) costs the robust fit itself 1e-10 of J at fast
    and 7e-9 to 1.8e-8 at tight, measured against its own B-form, the
    spread set by the thread count of the host's eigh and products, so at
    tight the robust fit is not reproducible to 1e-8 by the JAX package
    itself;
  * the H2O B3LYP 'fast'-tier SCF: 1e-8 Eh, both loops on their default
    rule (both stop at cycle 7; measured 2e-10 to 5.5e-9 across the
    host's thread counts, the robust fit's J rounding times E_coul ~ 47
    Eh);
  * the port's RI pipeline against the JAX package's SCF on the JAX
    package's own RI factor (J = B (B^T D), as the port's), both at the
    fixed point: 1e-9 Eh (measured 8e-11 at tight, 7e-12 at fast);
  * the same factor fed to both packages' prepare (_df_override): a
    Cholesky factor (the north star's case, identity metric: the same J/K
    contractions), 1e-9 Eh with both loops converged to ||dD|| < 1e-9; the
    RI tensors, the SCF bar above, 1e-8 Eh on the default rule (the JAX
    loop's robust-fit J stalls above ||dD|| 1e-9 there).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.integrals import density_fitting as jax_df
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.integrals import density_fitting as df
from quantum_compute_dft_tpu_torch.integrals.cholesky import (
    cholesky_eri_vectors,
)
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.driver import scf_host

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O = os.path.join(ROOT, "molecules", "H2O.xyz")
TIERS = ["fast", "tight"]
# both loops to the fixed point (see the module docstring)
TIGHT = {"conv_tol_d": 1e-9, "conv_tol_e": 1e-11}


@pytest.fixture(scope="module")
def tensors():
    """{tier: (JAX j3c, JAX v2c, port j3c, port v2c)} for H2O, numpy."""
    jmol = jax_from_xyz_file(H2O)
    mol = from_xyz_file(H2O)
    out = {}
    for tier in TIERS:
        jj, jv = jax_df.df_tensors(jax_build_basis(jmol), jmol, aux_level=tier)
        pj, pv = df.df_tensors(build_basis(mol), mol, aux_level=tier)
        out[tier] = (np.asarray(jj), np.asarray(jv), pj.numpy(), pv.numpy())
    return out


@pytest.mark.parametrize("tier", TIERS)
def test_aux_table_matches_jax(tier):
    ref = jax_df.build_aux_cart_table(jax_from_xyz_file(H2O),
                                      **jax_df.AUX_LEVELS[tier])
    ours = df.build_aux_cart_table(from_xyz_file(H2O), **df.AUX_LEVELS[tier])
    assert df.AUX_LEVELS == jax_df.AUX_LEVELS
    for a, b in zip(ours, ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    if tier == "tight":   # g functions on the p-block atom (O: l_occ 1 + 3)
        assert ours[0].sum(axis=1).max() == 4


@pytest.mark.parametrize("tier", TIERS)
def test_df_tensors_match_jax(tensors, tier):
    jj, jv, pj, pv = tensors[tier]
    assert pj.shape == jj.shape and pv.shape == jv.shape
    assert np.abs(pj - jj).max() < 1e-11 * np.abs(jj).max()
    assert np.abs(pv - jv).max() < 1e-11 * np.abs(jv).max()


@pytest.mark.parametrize("tier", TIERS)
def test_metric_rank_matches_jax(tensors, tier):
    _, jv, _, pv = tensors[tier]
    v_pinv, _ = jax_df.metric_factors(jv)
    # V^+ V is the projector on the kept directions: its trace counts them
    kept_jax = int(round(np.trace(v_pinv @ jv)))
    for v2c in (jv, pv):
        x, kept = df.metric_factors(torch.tensor(v2c))
        assert kept == kept_jax and x.shape == (v2c.shape[0], kept)
        x = x.numpy()
        assert np.abs(x.T @ v2c @ x - np.eye(kept)).max() < 1e-6
    if tier == "tight":   # lindep 1e-9 drops directions of this metric
        assert kept_jax < jv.shape[0]


@pytest.mark.parametrize("tier", TIERS)
def test_ri_jk_match_jax(tensors, tier):
    jj, jv, _, _ = tensors[tier]
    rng = np.random.default_rng(11)
    a = rng.standard_normal(jj.shape[:2])
    dm = a + a.T
    cj, ck, b64 = jax_df.make_df_builders(jnp.asarray(jj), jnp.asarray(jv),
                                          k_dtype="float64")
    oj, ok, b = df.make_df_builders(torch.tensor(jj), torch.tensor(jv),
                                    k_dtype="float64")
    assert b.dtype == torch.float64 and b.shape[2] <= jv.shape[0]
    dm_t = torch.tensor(dm)
    j, k = oj(dm_t).numpy(), ok(dm_t).numpy()
    j_fit, k_ref = np.asarray(cj(jnp.asarray(dm))), np.asarray(ck(jnp.asarray(dm)))
    b64 = np.asarray(b64)
    j_b = np.einsum("ijq,q->ij", b64, np.einsum("ijq,ij->q", b64, dm))
    assert np.abs(k - k_ref).max() < 1e-11 * np.abs(k_ref).max()
    assert np.abs(j - j_b).max() < 1e-11 * np.abs(j_b).max()
    tol_fit = {"fast": 1e-8, "tight": 1e-7}[tier]
    assert np.abs(j - j_fit).max() < tol_fit * np.abs(j_fit).max()


def test_ri_fast_scf_matches_jax():
    js = jax_kohn_sham.prepare(jax_from_xyz_file(H2O), "B3LYP", grid_level=1,
                               density_fit=True, df_aux="fast")
    ref = jax_scf_host(js.sys, js.functional)
    setup = kohn_sham.prepare(from_xyz_file(H2O), "B3LYP", grid_level=1,
                              density_fit=True, df_aux="fast", device="cpu")
    assert setup.df_aux == "fast" and setup.ri_time > 0.0
    assert setup.ri_split["naux"] == setup.sys.df_bq.shape[0]
    assert setup.sys.eri is None and setup.sys.df_bq32 is not None
    # the JAX package's GGA potential (jax_potential)
    res = scf_host(setup.sys, setup.functional.jax_potential())
    assert ref.converged and res.converged
    assert abs(res.e_tot - ref.e_tot) < 1e-8


@pytest.mark.parametrize("tier", TIERS)
def test_ri_scf_matches_jax_b_form(tensors, tier):
    """The port's own RI pipeline (its integrals, metric and B) against
    the JAX package's SCF on the JAX package's own RI factor B = j3c
    V^(-1/2) (its make_df_builders' K factor, as an identity-metric
    override), both loops to the fixed point: the reference energies of
    docs/ri_reference_cpu.json are made this way (tools/ri_reference.py)."""
    jj, jv, _, _ = tensors[tier]
    _, _, b64 = jax_df.make_df_builders(jnp.asarray(jj), jv,
                                        k_dtype="float64")
    js = jax_kohn_sham.prepare(jax_from_xyz_file(H2O), "B3LYP", grid_level=1,
                               _df_override=(np.asarray(b64), None))
    ref = jax_scf_host(js.sys, js.functional, **TIGHT)
    setup = kohn_sham.prepare(from_xyz_file(H2O), "B3LYP", grid_level=1,
                              density_fit=True, df_aux=tier, device="cpu")
    res = scf_host(setup.sys, setup.functional.jax_potential(), **TIGHT)
    assert ref.converged and res.converged
    assert abs(res.e_tot - ref.e_tot) < 1e-9


@pytest.mark.parametrize("kind", ["cholesky", "ri"])
def test_df_override_matches_jax(tensors, kind):
    """The same factorization handed to both packages' prepare: a Cholesky
    factor of another tolerance than prepare's own (the north star's
    case), or the RI tensors with their metric."""
    if kind == "cholesky":
        override = (cholesky_eri_vectors(build_basis(from_xyz_file(H2O)),
                                         tol=1e-5).numpy(), None)
        kw, tol = TIGHT, 1e-9
    else:
        override, kw, tol = tensors["fast"][:2], {}, 1e-8
    js = jax_kohn_sham.prepare(jax_from_xyz_file(H2O), "B3LYP", grid_level=1,
                               _df_override=override)
    ref = jax_scf_host(js.sys, js.functional, **kw)
    setup = kohn_sham.prepare(from_xyz_file(H2O), "B3LYP", grid_level=1,
                              _df_override=override, device="cpu")
    assert setup.df_aux == "override" and setup.sys.eri is None
    res = scf_host(setup.sys, setup.functional.jax_potential(), **kw)
    assert ref.converged and res.converged
    assert abs(res.e_tot - ref.e_tot) < tol

