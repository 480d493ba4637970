"""The fused XC variants' plain PyTorch versions (K3 = phi_split, the K1
ablations, the two row-sum modes) against the Pallas kernel in interpret
mode and the f64 engine, on H2O grid 1 with the JAX package's setup arrays
and a seeded perturbed SAD density (as tests/test_torch_fused_xc.py).

Tolerances, with what was measured on these inputs:

* Plain K3 vs ``xc_step_pallas(..., phi_split=True)``: relative dE 2e-5
  and max dV 2e-5, the K1-vs-Pallas bound (measured <= 1.1e-5 and
  1.5e-5).  Both sides drop the same D_l AO_l term; what is left is the
  Pallas side's own error: V from its 3-pass bf16 V product, E from the
  interpret-mode dot summing the hi and lo parts of w e sequentially in
  f32 over one 49,152-point tile (a sequential f32 sum of those parts
  reproduces its E to the last bit).  K3 vs the f64 engine: 3e-4 and
  3e-3, the JAX package's K3 contract (tests/test_pallas.py; measured
  1.5e-6 and 1.2e-6).
* Ablations vs the Pallas kernel with ``_ENV_ABLATE`` set and
  ``_ENV_VPU_REDUCE`` on (the f32 row sums the port's ablations take):
  relative dE 1e-6 (measured <= 1.9e-7); max dV 5e-5 of max(1, max |V|),
  because the ablated B^T reaches 1e10 (nofunc: vsigma = sigma) or
  cancels (noprod) while the Pallas V product keeps its 3-pass bf16 error
  (measured 2.1e-5 of |V| at B3LYP noprod, 1.7e-6 at nofunc).
* ``reduce="split2"`` vs the Pallas default (its 2-pass row sums):
  2e-5 and 2e-5 (measured <= 1.2e-5 and 1.5e-5, the Pallas side's
  sequential E sum and V product as above).  ``reduce="f32"`` vs
  ``_ENV_VPU_REDUCE``: relative dE 1e-6 (measured <= 1.1e-7), max dV 2e-5
  (the V product, 1.4e-5).
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import quantum_compute_dft_tpu.engine.pallas_xc as px
from quantum_compute_dft_tpu import kohn_sham as jax_kohn_sham
from quantum_compute_dft_tpu.mol import from_atoms as jax_from_atoms
from quantum_compute_dft_tpu.scf.driver import initial_guess as jax_guess
from quantum_compute_dft_tpu_torch.engine import fused_xc
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_step
from quantum_compute_dft_tpu_torch.xc import FUNCTIONALS

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H2O = [("O", (0.0, 0.0, 0.127)), ("H", (0.0, 0.758, -0.509)),
       ("H", (0.0, -0.758, -0.509))]


@pytest.fixture
def interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(px.pl, "pallas_call", patched)


@pytest.fixture
def pallas_mode(interpret, monkeypatch):
    """Sets pallas_xc's import-time knobs.  xc_step_pallas's jit cache keys
    only on static arguments, so caches are cleared before (else an
    unablated trace replays) and after (else the ablated one does)."""

    def set_mode(ablate="", vpu_reduce=False):
        monkeypatch.setattr(px, "_ENV_ABLATE", ablate)
        monkeypatch.setattr(px, "_ENV_VPU_REDUCE", vpu_reduce)
        jax.clear_caches()

    yield set_mode
    monkeypatch.undo()
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """JAX setup, a seeded perturbed SAD density and the planes as torch
    (shared by the tests; nothing writes to them)."""
    setup = jax_kohn_sham.prepare(jax_from_atoms(H2O), name, grid_level=1)
    s = setup.sys
    rng = np.random.default_rng(11)
    pert = rng.standard_normal(s.hcore.shape) * 1e-2
    dm = np.asarray(jax_guess(s)) + pert + pert.T
    grad = None if s.ao_grad is None else torch.tensor(np.asarray(s.ao_grad))
    planes = (torch.tensor(dm), torch.tensor(np.asarray(s.ao)),
              torch.tensor(np.asarray(s.weights)), grad)
    return setup, dm, planes


def _pallas(setup, dm, phi_split=False):
    e, v = px.xc_step_pallas(setup.functional, jnp.asarray(dm), setup.sys.ao,
                             setup.sys.weights, setup.sys.ao_grad, tile=512,
                             phi_split=phi_split)
    return float(e), np.asarray(v)


def _close(e, v, e_ref, v_ref, tol_e, tol_v):
    e = float(e)
    v = v.numpy() if isinstance(v, torch.Tensor) else v
    v_ref = v_ref.numpy() if isinstance(v_ref, torch.Tensor) else v_ref
    assert abs(e - e_ref) < tol_e * abs(e_ref), (e, e_ref)
    dv = np.abs(v - v_ref).max()
    assert dv < tol_v, dv


@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP"])
def test_plain_k3_matches_pallas_phi_split_and_f64(interpret, name):
    setup, dm, planes = _inputs(name)
    fn = FUNCTIONALS[name]
    e_px, v_px = _pallas(setup, dm, phi_split=True)
    # the Pallas kernel's V_xc has half the sigma term (jax_potential)
    e, v = fused_xc.xc_step_fused(fn.jax_potential(), *planes,
                                  phi_split=True)
    assert e.dtype == v.dtype == torch.float64
    _close(e, v, e_px, v_px, 2e-5, 2e-5)
    e, v = fused_xc.xc_step_fused(fn, *planes, phi_split=True)
    e64, v64 = xc_step(fn, *planes)
    _close(e, v, float(e64), v64, 3e-4, 3e-3)
    # the split is in effect: K3 sits further from the f64 engine than K1
    e1, _ = fused_xc.xc_step_fused(fn, *planes)
    assert abs(float(e) - float(e64)) > 10 * abs(float(e1) - float(e64))


@pytest.mark.parametrize("name", ["GGA", "B3LYP"])
@pytest.mark.parametrize("ablate", fused_xc.ABLATIONS)
def test_ablation_matches_pallas(pallas_mode, name, ablate):
    setup, dm, planes = _inputs(name)
    pallas_mode(ablate=ablate, vpu_reduce=True)
    e_px, v_px = _pallas(setup, dm)
    e, v = fused_xc.xc_step_fused(FUNCTIONALS[name].jax_potential(), *planes,
                                  ablate=ablate)
    _close(e, v, e_px, v_px, 1e-6, 5e-5 * max(1.0, np.abs(v_px).max()))
    if ablate == "nov":
        assert not v.any()


@pytest.mark.parametrize("name", ["LDA", "GGA", "B3LYP"])
def test_reduction_modes_match_pallas(pallas_mode, name):
    setup, dm, planes = _inputs(name)
    fn = FUNCTIONALS[name]
    pallas_mode()
    e_px, v_px = _pallas(setup, dm)
    e, v = fused_xc.xc_step_fused(fn.jax_potential(), *planes,
                                  reduce="split2")
    _close(e, v, e_px, v_px, 2e-5, 2e-5)
    pallas_mode(vpu_reduce=True)
    e_px, v_px = _pallas(setup, dm)
    e, v = fused_xc.xc_step_fused(fn.jax_potential(), *planes,
                                  reduce="f32")
    _close(e, v, e_px, v_px, 1e-6, 2e-5)


def test_split_rounds_as_jax():
    """hi/lo of the port's split are the JAX package's, bit for bit
    (round-to-nearest-even to bf16 in both)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-8, 8, 4096)
         ).astype(np.float32)
    hi, lo = fused_xc._split(torch.tensor(x))
    jh = jnp.asarray(x).astype(jnp.bfloat16)
    jl = (jnp.asarray(x) - jh.astype(jnp.float32)).astype(jnp.bfloat16)
    assert np.array_equal(hi.numpy(), np.asarray(jh.astype(jnp.float32)))
    assert np.array_equal(lo.numpy(), np.asarray(jl.astype(jnp.float32)))


@pytest.mark.parametrize("kw,match", [
    ({"ablate": "nov"}, "GGA body only"),
    ({"ablate": "nophi"}, "GGA body only"),
    ({"ablate": "vpu"}, "ablate must be one of"),
    ({"reduce": "bf16"}, "reduce must be one of"),
])
def test_bad_variants_raise(kw, match):
    setup, dm, planes = _inputs("LDA")
    with pytest.raises(ValueError, match=match):
        fused_xc.xc_step_fused(FUNCTIONALS["LDA"], *planes, **kw)


@pytest.mark.parametrize("kw", [{"ablate": "noprod", "reduce": "split2"},
                                {"ablate": "nophi", "phi_split": True}])
def test_ablation_takes_no_other_variant(kw):
    with pytest.raises(ValueError, match="one phase of K1"):
        fused_xc.launch_names(FUNCTIONALS["GGA"], **kw)


@pytest.mark.parametrize("name,kw,match", [
    ("LDA", {}, "GGA body only"),
    ("GGA", {"ablate": "nov"}, "no other variant"),
    ("GGA", {"phi_split": True}, "no other variant"),
])
def test_base_is_k1_on_the_four_kernel_pipeline_only(name, kw, match):
    with pytest.raises(ValueError, match=match):
        fused_xc.launch_names(FUNCTIONALS[name], base=True, **kw)


def test_launch_names():
    gga, lda = FUNCTIONALS["GGA"], FUNCTIONALS["LDA"]
    assert fused_xc.launch_names(gga) == ["K1"]
    assert fused_xc.launch_names(lda) == ["K2"]
    assert fused_xc.launch_names(lda, phi_split=True) == ["K3"]
    assert fused_xc.launch_names(gga, reduce="split2") == ["split2"]
    assert fused_xc.launch_names(gga, phi_split=True,
                                 reduce="split2") == ["K3", "split2"]
    assert fused_xc.launch_names(gga, ablate="phi3") == ["phi3"]
    assert fused_xc.launch_names(gga, base=True) == ["K1base"]
    assert set(fused_xc.LAUNCHES) == {"K1", "K2", "K1base", "K3", "split2",
                                      *fused_xc.ABLATIONS}
    for name, kw in fused_xc.VARIANTS.items():
        assert fused_xc.launch_names(gga, **kw) == [name]


def test_route():
    """Which C entry each variant reaches: K1/K2, K3/phi3, nophi and nov
    the tensor-core entry (3 x TF32, the bf16 split, no product, no V);
    only K1base, noprod, nofunc, split2 and K3 with split2 the four-kernel
    pipeline with its variant word."""
    gga, lda = FUNCTIONALS["GGA"], FUNCTIONALS["LDA"]
    assert fused_xc.route(gga) == fused_xc.route(lda) == ("tc", fused_xc.TF32X3)
    for fn in (gga, lda):
        assert fused_xc.route(fn, phi_split=True) == ("tc", fused_xc.BF16X3)
    assert fused_xc.route(gga, ablate="phi3") == ("tc", fused_xc.BF16X3)
    assert fused_xc.route(gga, ablate="nophi") == ("tc", fused_xc.PHI_AO)
    assert fused_xc.route(gga, ablate="nov") == (
        "tc", fused_xc.TF32X3 | fused_xc.NO_V)
    assert fused_xc.route(gga, phi_split=True, reduce="split2") == (
        "pipeline", 1 | 32)
    assert fused_xc.route(lda, reduce="split2") == ("pipeline", 32)
    assert fused_xc.route(gga, base=True) == ("pipeline", 0)
    for a in ("noprod", "nofunc"):
        assert fused_xc.route(gga, ablate=a) == (
            "pipeline", fused_xc._VAR_BITS[a])
    pipeline = {name for name, kw in fused_xc.VARIANTS.items()
                if fused_xc.route(gga, **kw)[0] == "pipeline"}
    assert pipeline == {"K1base", "noprod", "nofunc", "split2"}


class _FakeLib:
    """Stands in for the built library: records the C entry a launch calls
    and its arguments (no card needed)."""

    def __init__(self):
        self.calls = []

    def fused_xc_tc_v_chunk(self, npad, gpad):
        return 16

    def fused_xc_tc(self, *args):
        self.calls.append(("fused_xc_tc", args))
        return 0

    def fused_xc(self, *args):
        self.calls.append(("fused_xc", args))
        return 0


@pytest.mark.parametrize("name,kw,launch,mode", [
    ("B3LYP", {"phi_split": True}, "K3", 1),
    ("LDA", {"phi_split": True}, "K3", 1),
    ("GGA", {"ablate": "phi3"}, "phi3", 1),
    ("B3LYP", {}, "K1", 0),
    ("LDA", {}, "K2", 0),
    ("B3LYP", {"ablate": "nophi"}, "nophi", 2),
    ("GGA", {"ablate": "nov"}, "nov", 4),
])
def test_launch_reaches_tensor_core_entry(monkeypatch, name, kw, launch,
                                          mode):
    """K3 (both bodies) and phi3 launch fused_xc_tc in the bf16 mode (1),
    K1/K2 in the TF32 mode (0), nophi with no product (2: no density, so
    no f64 copy and no padded-density scratch) and nov with the no-V bit
    (4: no V partials), one call, counted under their names; the
    four-kernel entry is not called (no phi_D or B^T plane)."""
    fake = _FakeLib()
    monkeypatch.setattr(fused_xc, "_lib", lambda: fake)
    monkeypatch.setattr(fused_xc, "_stream", lambda: 0)
    monkeypatch.setitem(fused_xc.LAUNCHES, launch, 0)
    _, dm, (dm_t, ao, w, grad) = _inputs(name)
    fn = FUNCTIONALS[name]
    aot, wt, grads = fused_xc.pack_inputs(ao, w, grad,
                                          needs_grad=fn.needs_grad)
    fused_xc._launch(fn, dm_t, aot, wt, grads, dm.shape[0],
                     kw.get("phi_split", False), kw.get("ablate", ""), "f32",
                     False)
    [(entry, args)] = fake.calls
    assert entry == "fused_xc_tc"
    assert args[:2] == (fn.kind, mode)
    # dm64, dm_p and v_part: null exactly where the mode does not read them
    assert (args[6] is None, args[7] is None) == ((launch == "nophi",) * 2)
    assert (args[16] is None) == (launch == "nov")
    assert fused_xc.LAUNCHES[launch] == 1


def test_sweep_tool_prints_every_variant_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_xc_sweep.py"),
         "H2O", "1", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert [r["variant"] for r in rows] == list(fused_xc.VARIANTS)
    for r in rows:
        assert np.isfinite(r["e_xc"]) and r["e_xc"] == r["e_xc_plain"]
        assert (r["nao"], r["npad"], r["grid_level"]) == (7, 8, 1)
        assert r["ms"] is None and r["gpu"] is None  # no time on the CPU
    by = {r["variant"]: r["e_xc"] for r in rows}
    assert by["nov"] == by["K1"] == by["K1base"] and by["phi3"] == by["K3"]
    assert by["K3"] != by["K1"]
    # K3, phi3, nophi and nov are read against K1 (one pipeline), the rest
    # against K1base
    assert {r["variant"]: r["base"] for r in rows} == {
        "K1": None, "K1base": None, "K3": "K1", "phi3": "K1",
        "nophi": "K1", "noprod": "K1base", "nofunc": "K1base",
        "nov": "K1", "split2": "K1base"}
