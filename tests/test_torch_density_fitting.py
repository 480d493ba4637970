"""The port's density fitting (pivoted-Cholesky factor, DF J/K, the DF
branch of prepare and the CLI) against the JAX package, on the CPU.

Tolerances: L L^T against the JAX in-core ERIs, 1e-7 at tol 1e-7 (the
factorization's elementwise a-priori bound) and below tol at tol 1e-4; the
f64 J/K fed the same numpy factor, 1e-12 (the same contractions in another
summation order); the f32 aux-major J/K, 1e-6 relative to the largest
element (both full-f32 products over the same factor, another order); the
DF SCF against the JAX in-core SCF, the DF parity bar of
tests/test_density_fitting.py, 1e-6 Eh.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.basis import build_basis as jax_build_basis
from quantum_compute_dft_tpu.integrals import eri_full as jax_eri_full
from quantum_compute_dft_tpu.integrals.density_fitting import (
    _cd_coulomb_q as jax_cd_coulomb_q,
)
from quantum_compute_dft_tpu.integrals.density_fitting import (
    make_df_builders as jax_make_df_builders,
)
from quantum_compute_dft_tpu.integrals.density_fitting import (
    make_fast_cd_builders as jax_make_fast_cd_builders,
)
from quantum_compute_dft_tpu.mol import from_xyz_file as jax_from_xyz_file
from quantum_compute_dft_tpu.scf.driver import scf_host as jax_scf_host
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.basis import build_basis
from quantum_compute_dft_tpu_torch.integrals import cholesky, two_electron
from quantum_compute_dft_tpu_torch.integrals import density_fitting as df
from quantum_compute_dft_tpu_torch.integrals.cholesky import (
    cholesky_eri_vectors,
)
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.scf.driver import scf_host

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H2O = os.path.join(ROOT, "molecules", "H2O.xyz")


@pytest.fixture(scope="module")
def factor():
    """(port factor L as numpy at tol 1e-7, JAX in-core ERIs, dm)."""
    l_vec = cholesky_eri_vectors(build_basis(from_xyz_file(H2O))).numpy()
    eri = np.asarray(jax_eri_full(jax_build_basis(jax_from_xyz_file(H2O))))
    rng = np.random.default_rng(5)
    a = rng.standard_normal(eri.shape[:2])
    return l_vec, eri, a + a.T


def test_cholesky_reproduces_jax_eris(factor):
    l_vec, eri, _ = factor
    assert l_vec.dtype == np.float64 and l_vec.shape[:2] == eri.shape[:2]
    assert np.abs(np.einsum("ijr,klr->ijkl", l_vec, l_vec) - eri).max() < 1e-7


def test_cholesky_truncates_below_full_rank(factor):
    _, eri, _ = factor
    tol = 1e-4
    l_vec = cholesky_eri_vectors(build_basis(from_xyz_file(H2O)),
                                 tol=tol).numpy()
    nao = eri.shape[0]
    assert l_vec.shape[2] < nao * (nao + 1) // 2   # genuinely truncated
    assert np.abs(np.einsum("ijr,klr->ijkl", l_vec, l_vec) - eri).max() < tol


def test_df_f64_jk_match_jax(factor):
    l_vec, _, dm = factor
    jj, jk, _ = jax_make_df_builders(jnp.asarray(l_vec), None, build_k=True,
                                     k_dtype="float64")
    cj, ck, b = df.make_df_builders(torch.tensor(l_vec), None, build_k=True,
                                    k_dtype="float64")
    assert b.dtype == torch.float64
    dm_t = torch.tensor(dm)
    j_ref, k_ref = np.asarray(jj(jnp.asarray(dm))), np.asarray(jk(jnp.asarray(dm)))
    assert np.abs(cj(dm_t).numpy() - j_ref).max() < 1e-12
    assert np.abs(ck(dm_t).numpy() - k_ref).max() < 1e-12
    # the aux-major f64 J the SCF uses
    bq = np.ascontiguousarray(np.moveaxis(l_vec, 2, 0))
    j_q = df._cd_coulomb_q(torch.tensor(bq), dm_t).numpy()
    assert np.abs(j_q - np.asarray(jax_cd_coulomb_q(jnp.asarray(bq),
                                                    jnp.asarray(dm)))).max() < 1e-12
    assert np.abs(j_q - j_ref).max() < 1e-12


def test_df_f32_aux_major_jk_match_jax(factor):
    l_vec, _, dm = factor
    jj, jk, jb = jax_make_fast_cd_builders(jnp.asarray(l_vec))
    cj, ck, b = df.make_fast_cd_builders(torch.tensor(l_vec))
    assert b.dtype == torch.float32 and tuple(b.shape) == tuple(jb.shape)
    dm_t = torch.tensor(dm)
    for ours, ref in ((cj(dm_t), jj(jnp.asarray(dm))),
                      (ck(dm_t), jk(jnp.asarray(dm)))):
        ref = np.asarray(ref)
        assert ours.dtype == torch.float64
        assert np.abs(ours.numpy() - ref).max() < 1e-6 * np.abs(ref).max()


def test_f32_builders_refuse_tf32(factor, monkeypatch):
    l_vec, _, dm = factor
    _, ck, _ = df.make_fast_cd_builders(torch.tensor(l_vec))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full f32"):
        ck(torch.tensor(dm))


def test_df_scf_matches_jax_incore():
    js = jax_kohn_sham.prepare(jax_from_xyz_file(H2O), "B3LYP", grid_level=1,
                               density_fit=False)
    ref = jax_scf_host(js.sys, js.functional)
    setup = kohn_sham.prepare(from_xyz_file(H2O), "B3LYP", grid_level=1,
                              density_fit=True, device="cpu")
    s = setup.sys
    assert s.eri is None and s.df_bq.dtype == torch.float64
    assert s.df_bq32.dtype == torch.float32 and s.df_l is not None
    # the JAX package's GGA potential (jax_potential)
    res = scf_host(s, setup.functional.jax_potential())
    assert ref.converged and res.converged
    assert abs(res.e_tot - ref.e_tot) < 1e-6


@pytest.mark.parametrize("df_aux", ["tight", "fast"])
def test_ri_aux_tiers_not_ported(df_aux):
    """The RI tiers, which raised NotImplementedError before they were
    ported, now build an RI factor (tests/test_torch_ri.py holds them to
    the JAX package); an unknown tier still raises."""
    setup = kohn_sham.prepare(from_xyz_file(H2O), "LDA", grid_level=1,
                              density_fit=True, df_aux=df_aux, device="cpu")
    assert setup.df_aux == df_aux and setup.sys.eri is None
    assert setup.sys.df_l is None   # LDA: no exact exchange, no K factor
    assert setup.sys.df_bq.shape[0] == setup.ri_split["naux"]
    with pytest.raises(ValueError, match="df_aux"):
        kohn_sham.prepare(from_xyz_file(H2O), "LDA", grid_level=1,
                          density_fit=True, df_aux="loose", device="cpu")


def test_cli_density_fit_on_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    # the CLI's entry, with the JAX package's GGA potential (half_sigma, a
    # keyword of cli.run and no option of the command) for its energy
    run_cli = ("import sys; from quantum_compute_dft_tpu_torch import cli; "
               "sys.exit(0 if cli.run(sys.argv[1:], half_sigma=True)[1]"
               ".converged else 2)")
    out = subprocess.run(
        [sys.executable, "-c", run_cli, "B3LYP",
         "H2O", "--grid-level", "1", "--device", "cpu", "--density-fit",
         "on", "--df-aux", "parity"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Cholesky DF, rank 28" in out.stdout
    assert "Converged in" in out.stdout
    e = float(out.stdout.split("Total energy :")[1].split()[0])
    # the JAX package's in-core f64 SCF on the same input
    assert abs(e - (-75.32004987)) < 1e-6


def _old_diagonal(pairs, rows, block):
    """The Cholesky's residual diagonal as it ran before its entry point:
    diag_runner's tiles over the whole pair list."""
    run_diag = two_electron.diag_runner(pairs.l_pair, "cpu")
    assert np.array_equal(rows, np.arange(len(pairs.p)))
    return torch.cat([run_diag(pairs.p[s:s + block], pairs.P[s:s + block],
                               pairs.et[s:s + block], pairs.cw[s:s + block])
                      for s in range(0, len(rows), block)])


def _old_columns(pairs, rows, cols, block):
    """A pivot panel as the Cholesky's run_panel ran it before its entry
    point: the screened pairs gathered, their rows in blocks against the
    pivots' pairs."""
    run_block = two_electron._quartet_kernel(pairs.l_pair, "cpu")
    sel_t = torch.as_tensor(rows)
    p_s, P_s, et_s, cw_s = (pairs.p[sel_t], pairs.P[sel_t],
                            pairs.et[sel_t], pairs.cw[sel_t])
    pos = {int(r): i for i, r in enumerate(rows)}
    pt = torch.as_tensor([pos[int(c)] for c in cols])
    pb, Pb, eb, cb = p_s[pt], P_s[pt], et_s[pt], cw_s[pt]
    return torch.cat([
        run_block(p_s[s:s + block], P_s[s:s + block], et_s[s:s + block],
                  cw_s[s:s + block], pb, Pb, eb, cb)
        for s in range(0, len(rows), block)])


@pytest.mark.parametrize("block", [8, 128])
def test_cholesky_on_the_cpu_launches_no_kernel_and_keeps_its_factor(
        block, monkeypatch):
    """On the CPU the factorization reports eri_kernel_launches 0 and its
    factor is bitwise the one of the per-block loops it ran before (blocks
    of 8: a ragged last row block and several panels; 128: one of each)."""
    basis = build_basis(from_xyz_file(H2O))
    t = {}
    new = cholesky_eri_vectors(basis, block=block, timings=t)
    assert t["eri_kernel_launches"] == 0 and t["cholesky_panels"] >= 1
    monkeypatch.setattr(cholesky, "eri_diagonal", _old_diagonal)
    monkeypatch.setattr(cholesky, "eri_columns", _old_columns)
    t_old = {}
    assert torch.equal(cholesky_eri_vectors(basis, block=block,
                                            timings=t_old), new)
    assert t_old["cholesky_panels"] == t["cholesky_panels"]


@pytest.mark.parametrize("density_fit", [False, True])
def test_prepare_reports_eri_kernel_launches(density_fit, tmp_path,
                                             monkeypatch):
    """setup_split carries eri_kernel_launches where the quartet stage ran
    (the in-core ERIs or the Cholesky; 0 on the CPU) and not where the
    setup cache served them."""
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path))
    mol = from_xyz_file(H2O)
    cold, warm = (kohn_sham.prepare(mol, "LDA", grid_level=1,
                                    density_fit=density_fit,
                                    device="cpu").setup_split
                  for _ in range(2))
    assert cold["eri_kernel_launches"] == 0
    assert "eri_kernel_launches" not in warm
