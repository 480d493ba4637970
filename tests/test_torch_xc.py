"""Port functionals and f64 XC engine against the JAX package.

Tolerances: exc_vxc to 1e-12 relative (atol 1e-15) on seeded random
(rho, sigma) with reduced gradients in the range real densities have,
against the JAX formulas evaluated with exact atan/asinh/expm1 (the port
uses the plain functions; the JAX package composes them from exp/log/sqrt
for the TPU compiler, ~4e-13 relative error, which PBE correlation's
potential amplifies to ~2e-10) -- and to 1e-9 against the JAX package as
it stands.  PBE's vsigma is held to 1e-9 in both: its exchange and
correlation gradient terms cancel at small reduced gradient by
construction (mu = beta pi^2 / 3), which turns last-ulp differences of
pow/sqrt into ~2e-10 relative.  xc_step and
xc_energy to 1e-10 absolute on H2O at grid 1 (grid sums of ~1e4 terms).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quantum_compute_dft_tpu.xc.functionals as jax_functionals
from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.engine.xc_engine import xc_energy as jax_xc_energy
from quantum_compute_dft_tpu.engine.xc_engine import xc_step as jax_xc_step
from quantum_compute_dft_tpu.mol import from_atoms as jax_from_atoms
from quantum_compute_dft_tpu.scf.driver import initial_guess as jax_guess
from quantum_compute_dft_tpu.xc import FUNCTIONALS as JAX_FUNCTIONALS
from quantum_compute_dft_tpu_torch import kohn_sham
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_energy, xc_step
from quantum_compute_dft_tpu_torch.mol import from_atoms
from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

torch.set_num_threads(1)

H2O = [("O", (0.0, 0.0, 0.127)), ("H", (0.0, 0.758, -0.509)),
       ("H", (0.0, -0.758, -0.509))]


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP", "HF"])
def test_exc_vxc_matches_jax(monkeypatch, name, exact):
    if exact:
        monkeypatch.setattr(jax_functionals, "_expm1", jnp.expm1)
        monkeypatch.setattr(jax_functionals, "_atan_pos", jnp.arctan)
        monkeypatch.setattr(jax_functionals, "_asinh_pos", jnp.arcsinh)
    rtol = 1e-12 if exact else 1e-9
    rng = np.random.default_rng(3)
    rho = 10.0 ** rng.uniform(-12, 3, 3000)
    # sigma = |grad rho|^2 ~ rho^(8/3) s^2 for reduced gradients s, with
    # s^2 over five decades
    sigma = rho ** (8.0 / 3.0) * 10.0 ** rng.uniform(-3, 2, 3000)
    ours = FUNCTIONALS[name].exc_vxc(torch.tensor(rho), torch.tensor(sigma))
    ref = JAX_FUNCTIONALS[name].exc_vxc(jnp.asarray(rho), jnp.asarray(sigma))
    assert (ours[2] is None) == (ref[2] is None)
    for i, (a, b) in enumerate(zip(ours, ref)):
        if a is None:
            continue
        tol = 1e-9 if (name == "GGA" and i == 2) else rtol
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                   atol=1e-15)


@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP"])
def test_xc_step_matches_jax(name):
    setup = jax_kohn_sham.prepare(jax_from_atoms(H2O), name, grid_level=1)
    s = setup.sys
    rng = np.random.default_rng(5)
    pert = rng.standard_normal(s.hcore.shape) * 1e-2
    dm = np.asarray(jax_guess(s)) + pert + pert.T
    e_ref, v_ref = jax_xc_step(setup.functional, jnp.asarray(dm), s.ao,
                               s.weights, s.ao_grad)
    e_ref2 = jax_xc_energy(setup.functional, jnp.asarray(dm), s.ao,
                           s.weights, s.ao_grad)

    def t(a):
        return None if a is None else torch.tensor(np.asarray(a))

    fn = FUNCTIONALS[name]
    # the JAX package's V_xc has half the sigma term (jax_potential)
    e, v = xc_step(fn.jax_potential(), t(dm), t(s.ao), t(s.weights),
                   t(s.ao_grad))
    e2 = xc_energy(fn, t(dm), t(s.ao), t(s.weights), t(s.ao_grad))
    assert abs(float(e) - float(e_ref)) < 1e-10
    assert abs(float(e2) - float(e_ref2)) < 1e-10
    assert np.abs(v.numpy() - np.asarray(v_ref)).max() < 1e-10
    assert np.abs(v.numpy() - v.numpy().T).max() == 0.0


def test_sigma_factor_lives_on_the_functional():
    """The GGA potential's convention is a field of Functional: 4 (V_xc =
    dE_xc/dD) on every entry, 2 on jax_potential()'s copy, which differs
    in no other field and is what prepare hands back as setup.functional."""
    assert {fn.sigma_factor for fn in FUNCTIONALS.values()} == {4.0}
    for fn in FUNCTIONALS.values():
        half = fn.jax_potential()
        assert half.sigma_factor == 2.0
        for field in dataclasses.fields(fn):
            if field.name != "sigma_factor":
                assert getattr(half, field.name) == getattr(fn, field.name)
    half = FUNCTIONALS["B3LYP"].jax_potential()
    setup = kohn_sham.prepare(from_atoms(H2O), half, grid_level=1,
                              device="cpu")
    assert setup.functional is half
