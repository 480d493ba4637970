"""The GGA potential at dE_xc/dD, and the benchmark's B3LYP cells.

V_xc of PBE and B3LYP in each of the port's three implementations (the f64
engine, K1's plain version fused_xc_reference, the C++ host engine of
runtime/) against a central difference of the f64 engine's xc_energy in D
along a seeded symmetric direction, on H2O at grid level 1; under the
functional's jax_potential() each gives the JAX package's V_xc (half the
sigma term) instead.  The port's SCF energies against the benchmark's
plain reference (bench_torch/reference, V_xc by autograd), in-core within
1e-8 Eh and through the Cholesky within dha.sto3g.grid3.cd's 3e-6 Eh; the
K build counts of SCFResult; the new cells' configuration and traffic; and
the GGA cells' readers in a CPU rehearsal of the harness.

Tolerances: f64 V against the difference (h = 1e-4, error O(h^2)) 1e-7
relative; K1's plain version is f32, 2e-6 relative (its own error against
the f64 engine, ~3e-7 here); the half term sits ~5% below, far outside
both.
"""

import contextlib
import io
import os
import sys
import time

import numpy as np
import pytest
import torch

from quantum_compute_dft_tpu.engine.xc_engine import xc_step as jax_xc_step
from quantum_compute_dft_tpu.xc.functionals import (
    FUNCTIONALS as JAX_FUNCTIONALS,
)
from quantum_compute_dft_tpu_torch import cli, kohn_sham
from quantum_compute_dft_tpu_torch.engine import fused_xc
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_energy, xc_step
from quantum_compute_dft_tpu_torch.mol import from_xyz_file
from quantum_compute_dft_tpu_torch.runtime import HostSolverWrapper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_torch import harness  # noqa: E402
from bench_torch.reference import basis as ref_basis  # noqa: E402

torch.set_num_threads(1)

H2O = os.path.join(ROOT, "molecules", "H2O.xyz")
STEP = 1e-4
# relative bar of V . X against the central difference, per implementation
BAR = {"f64": 1e-7, "fused_reference": 2e-6, "native": 1e-7}
IMPLS = list(BAR)
NEW_CELLS = ("vitb2.b3lyp.rerun", "dha.b3lyp.cold")


@pytest.fixture(scope="module")
def h2o():
    """{functional: (setup, seeded perturbed SAD density, seeded symmetric
    direction)} on H2O grid 1."""
    out = {}
    for name in ("PBE", "B3LYP"):
        setup = kohn_sham.prepare(from_xyz_file(H2O), name, grid_level=1,
                                  device="cpu")
        gen = torch.Generator().manual_seed(3)
        n = setup.nao
        p = 1e-2 * torch.randn((n, n), generator=gen, dtype=torch.float64)
        x = torch.randn((n, n), generator=gen, dtype=torch.float64)
        out[name] = setup, setup.sys.dm_sad + p + p.T, x + x.T
    return out


def _v(impl, setup, dm, fn=None):
    """V_xc of one implementation at dm (f64 tensor) under fn (default:
    the setup's functional)."""
    s, fn = setup.sys, fn or setup.functional
    if impl == "f64":
        return xc_step(fn, dm, s.ao, s.weights, s.ao_grad)[1]
    if impl == "fused_reference":
        aot, wt, grads = fused_xc.pack_inputs(s.ao, s.weights, s.ao_grad,
                                              needs_grad=True)
        return fused_xc.fused_xc_reference(fn, dm, aot, wt, grads,
                                           setup.nao)[1]
    vxc = np.zeros(tuple(dm.shape))
    HostSolverWrapper(fn.name, sigma_factor=fn.sigma_factor).compute_xc(
        np.ascontiguousarray(dm.numpy()), s.ao.numpy(), s.weights.numpy(),
        vxc, np.ascontiguousarray(s.ao_grad.numpy()))
    return torch.from_numpy(vxc)


def _central_difference(setup, dm, x):
    s, fn = setup.sys, setup.functional

    def e(d):
        return float(xc_energy(fn, d, s.ao, s.weights, s.ao_grad))

    return (e(dm + STEP * x) - e(dm - STEP * x)) / (2.0 * STEP)


@pytest.mark.parametrize("name", ["PBE", "B3LYP"])
@pytest.mark.parametrize("impl", IMPLS)
def test_vxc_is_the_derivative_of_exc(h2o, impl, name):
    """V_xc . X = dE_xc/dD . X: the sigma term in full."""
    setup, dm, x = h2o[name]
    fd = _central_difference(setup, dm, x)
    v = _v(impl, setup, dm)
    assert torch.equal(v, v.T)
    assert abs(float(torch.sum(v * x)) - fd) < BAR[impl] * abs(fd)
    # the JAX package's V_xc misses half the sigma term: ~5% here
    v_half = _v(impl, setup, dm, setup.functional.jax_potential())
    assert abs(float(torch.sum(v_half * x)) - fd) > 1e-2 * abs(fd)


@pytest.mark.parametrize("name", ["PBE", "B3LYP"])
@pytest.mark.parametrize("impl", IMPLS)
def test_half_sigma_gives_the_jax_packages_vxc(h2o, impl, name):
    """Under jax_potential() each implementation gives the JAX package's V_xc:
    the f64 engine and the C++ engine at f64 rounding, K1's plain version
    at its f32 bar against the f64 engine (the Pallas contract's 5e-5)."""
    setup, dm, _ = h2o[name]
    s = setup.sys
    import jax.numpy as jnp

    _, v_jax = jax_xc_step(JAX_FUNCTIONALS[name], jnp.asarray(dm.numpy()),
                           jnp.asarray(s.ao.numpy()),
                           jnp.asarray(s.weights.numpy()),
                           jnp.asarray(s.ao_grad.numpy()))
    v = _v(impl, setup, dm, setup.functional.jax_potential()).numpy()
    tol = 5e-5 if impl == "fused_reference" else 1e-9
    assert np.abs(v - np.asarray(v_jax)).max() < tol


def _job(argv):
    with contextlib.redirect_stdout(io.StringIO()):
        setup, res, _ = cli.run([*argv, "--device", "cpu"])
    return setup, res


@pytest.fixture(scope="module")
def jobs():
    """The CLI's jobs on H2O grid 1 (the fast schedule, the setup cache
    off) and the plain reference's energies there, by (functional,
    density fit)."""
    syms, xyz = harness.read_xyz(H2O)
    config = {"grid_level": 1}
    out = {}
    before = os.environ.get("DFT_SETUP_CACHE")
    os.environ["DFT_SETUP_CACHE"] = "0"
    try:
        for name, df in (("PBE", "off"), ("B3LYP", "off"), ("B3LYP", "on"),
                         ("LDA", "on")):
            setup, res = _job([name, H2O, "--grid-level", "1",
                               "--density-fit", df])
            ref = harness.reference_energies(config, [name], syms, xyz,
                                             "cpu")
            out[name, df] = setup, res, ref[name]
    finally:
        if before is None:
            os.environ.pop("DFT_SETUP_CACHE")
        else:
            os.environ["DFT_SETUP_CACHE"] = before
    return out


@pytest.mark.parametrize("name,df,limit", [
    ("PBE", "off", 1e-8), ("B3LYP", "off", 1e-8), ("B3LYP", "on", 3e-6)])
def test_scf_matches_the_plain_reference(jobs, name, df, limit):
    """At its functional's minimum: in-core within 1e-8 Eh, through the
    Cholesky factor within dha.sto3g.grid3.cd's limit."""
    setup, res, e_ref = jobs[name, df]
    assert res.converged and res.fast_cycles > 0
    assert (setup.sys.eri is None) == (df == "on")
    assert abs(res.e_tot - e_ref) < limit


@pytest.mark.parametrize("name,df", [("B3LYP", "on"), ("B3LYP", "off"),
                                     ("LDA", "on")])
def test_k_build_counts(jobs, name, df):
    """Density-fitted B3LYP: the f32 aux-major K in every kernel-phase
    cycle, the f64 K in every verify cycle and in the final energy;
    in-core every K is f64; LDA builds none."""
    _, res, _ = jobs[name, df]
    if name == "LDA":
        assert (res.k_builds_fast, res.k_builds_f64) == (0, 0)
    elif df == "on":
        assert res.k_builds_fast == res.fast_cycles > 0
        assert res.k_builds_f64 == res.verify_cycles + 1
    else:
        assert res.k_builds_fast == 0
        assert res.k_builds_f64 == res.n_iter + 1


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_new_cells_load(workload):
    c = harness.cell(workload)
    assert c["traffic"]["functionals"] == ["B3LYP"]
    assert c["workload"]["chips"] == 1
    syms, xyz = harness.read_xyz(os.path.join(ROOT,
                                              c["config"]["molecule"]))
    assert len(syms) == c["config"]["atoms"] and xyz.shape == (len(syms), 3)
    assert set(syms) <= set(ref_basis.Z_OF)
    assert c["config"]["energy_limit_eh"] == 3e-6


def test_vitamin_b2_is_the_published_molecule():
    """The configuration's molecule is the repository's Vitamin-B2.xyz:
    C17H20N4O6, nao 155 in STO-3G."""
    c = harness.cell("vitb2.b3lyp.rerun")["config"]
    with open(os.path.join(ROOT, c["molecule"])) as f:
        mine = f.read()
    with open(os.path.join(ROOT, "molecules", "Vitamin-B2.xyz")) as f:
        assert mine == f.read()
    syms, _ = harness.read_xyz(os.path.join(ROOT, c["molecule"]))
    assert {s: syms.count(s) for s in set(syms)} == {"C": 17, "H": 20,
                                                     "N": 4, "O": 6}
    nao = sum({"H": 1}.get(s, 5) for s in syms)
    assert nao == c["nao"] == 155


def test_gga_readers_on_a_cpu_rehearsal():
    """A traced rehearsal of the B3LYP rerun cell on the CPU (H2O grid 1):
    the GGA readers read the kept B3LYP job's SCF; the device's numbers
    are None off the card."""
    from bench_torch import gga_trace

    res = harness.run("vitb2.b3lyp.rerun", seed=2**31 + 17, seconds=0.1,
                      trace=True, t_start=time.perf_counter(), device="cpu",
                      config_path=os.path.join(ROOT, "bench_torch",
                                               "rehearsal",
                                               "h2o.sto3g.grid1.json"))
    assert res["correct"], res["compared"]
    m = res["metrics"]
    assert m["scf_gga.kernel_cycle_ms"]["value"] > 0.0
    assert m["scf_gga.verify_cycle_ms"]["value"] > 0.0
    assert "xc_gga.roofline_pct" not in m       # no card
    assert "scf_gga.k_device_ms" not in m       # no card
    assert gga_trace._MEMO[1]["spans"]["scf.k"]["host_ms"] > 0.0


def test_cholesky_tolerance_reaches_the_factor_and_its_cache(tmp_path,
                                                            monkeypatch):
    """prepare takes the factor's threshold from the functional (a tighter
    one under exact exchange: kohn_sham.CD_TOL_EXACT_EXCHANGE, loosened
    here so that H2O's factor falls below full rank), or from cd_tol, and
    the setup cache keeps a factor per threshold: B3LYP is not served
    LDA's factor, and each is served its own."""
    monkeypatch.setenv("DFT_SETUP_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("DFT_SETUP_CACHE", raising=False)
    monkeypatch.setattr(kohn_sham, "CD_TOL_EXACT_EXCHANGE", 1e-3)
    argv = [H2O, "--grid-level", "0", "--density-fit", "on"]
    runs = [_job([name] + argv)[0] for name in ("LDA", "B3LYP", "B3LYP",
                                                 "LDA")]
    rank = [s.sys.df_bq.shape[0] for s in runs]
    hit = ["cdvec" in s.cache_hits for s in runs]
    assert rank[1] < rank[0] == 28 and rank[2] == rank[1] and rank[3] == 28
    assert hit == [False, False, True, True]
    assert torch.equal(runs[3].sys.df_bq, runs[0].sys.df_bq)
    # cd_tol, the JAX package's threshold for every functional: B3LYP is
    # served LDA's factor
    jax_tol = kohn_sham.prepare(from_xyz_file(H2O), "B3LYP", grid_level=0,
                                density_fit=True, device="cpu",
                                cd_tol=kohn_sham.CD_TOL)
    assert "cdvec" in jax_tol.cache_hits
    assert torch.equal(jax_tol.sys.df_bq, runs[0].sys.df_bq)
