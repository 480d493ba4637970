"""Fused f32 XC build on Hopper: the port of engine/pallas_xc.py.

Kernels K1 (GGA body: PBE, B3LYP) and K2 (LDA body: LDA, and HF through
the zero functional) are hand-written CUDA C++ for sm_90a in
``csrc/fused_xc.cu`` (design, bounds and reduction scheme in its header
note).  They replace ``quantum_compute_dft_tpu/engine/pallas_xc.py::
_make_kernel``, and so do the variants that factory can build, chosen by
keyword (arguments, not environment variables, so one process can run
them all):

  * ``phi_split=True``: K3, phi_D as the 3-pass bf16 split on the tensor
    cores (``_make_kernel(phi_split=True)``), either body;
  * ``ablate=``: the GGA body with one phase stubbed (``_ENV_ABLATE``):
    "nophi" (phi_D := AO), "phi3" (phi_D through K3), "noprod" (row sums
    without the products), "nofunc" (e = rho, vrho = rho, vsigma = sigma),
    "nov" (no B^T and no V: V = 0).  Wrong results by design: they exist
    to attribute the kernel's time to its phases;
  * ``reduce="split2"``: the Pallas default's 2-pass bf16 row sums of rho,
    grad rho and E; the default "f32" is ``_ENV_VPU_REDUCE``'s plain sum.

The SCF passes no variant.  This module builds the kernels at first use
(nvcc, keyed by a hash of the sources), binds them with ctypes, and keeps
beside them:

  * ``fused_xc_reference``: the plain PyTorch f32 version of the same
    function and of every variant (the Pallas math, potentials by
    torch.autograd, matmuls in full f32);
  * ``LAUNCHES``: how many times each kernel was launched;
  * ``pack_inputs``: the one-time f32 transpose/pad of the AO planes
    (the port of ``pack_pallas_inputs``/``_pack_plane``).

Dispatch is by device with no fallback: ``fused_xc`` runs the plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from quantum_compute_dft_tpu_torch.xc.functionals import (
    Functional,
    value_and_potentials,
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("fused_xc.cu", "xc_functional.cuh")
# build outputs live in the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# largest npad checked on the card (chip_smoke.py phase 3: the 117-atom
# molecule, nao 377); the tiled kernels have no layout limit of their own
MAX_NPAD = 384
POINT_BLOCK = 128
CHUNK = 1024      # gpad is a multiple of it (the V chunk is too)
TILE = 64         # output tile edge of the kernels' two products
# target (output tiles x grid chunks) blocks of the V partial kernel: the
# chunk grows with npad so that the partial buffer stays ~V_BLOCKS * 16 KB
V_BLOCKS = 2048

ABLATIONS = ("nophi", "phi3", "noprod", "nofunc", "nov")
REDUCTIONS = ("f32", "split2")
# the variant word of the C entry (csrc/fused_xc.cu's k* constants)
_VAR_BITS = {"phi_split": 1, "nophi": 2, "phi3": 1, "noprod": 4,
             "nofunc": 8, "nov": 16, "split2": 32}

# each variant alone, by the LAUNCHES name it counts under -> the keywords
# of fused_xc (K1: none; tools/torch_xc_sweep.py times them all)
VARIANTS = {"K1": {}, "K3": {"phi_split": True},
            **{a: {"ablate": a} for a in ABLATIONS},
            "split2": {"reduce": "split2"}}

# kernel launches, counted by the wrapper where it launches: K1 (GGA body)
# and K2 (LDA body) with no variant; a variant counts under its own names
# instead (K3 for phi_split, the ablation's name, split2)
LAUNCHES = {"K1": 0, "K2": 0, **dict.fromkeys(VARIANTS, 0)}

_LIB = None


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _npad_for(n: int) -> int:
    return _round_up(n, 8)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused XC kernels need the CUDA "
                       "toolkit to build")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fused_xc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/fused_xc.cu unless the library for this source hash
    exists; returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(_CSRC / "fused_xc.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_xc.argtypes = [i, i, i, i, i, i] + [p] * 12
        lib.fused_xc.restype = i
        lib.xc_functional_eval.argtypes = [i, i] + [p] * 6
        lib.xc_functional_eval.restype = i
        _LIB = lib
    return _LIB


def _check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# packing (port of pack_pallas_inputs / _pack_plane)
# ---------------------------------------------------------------------------


def _pack_plane(plane, npad: int, gpad: int):
    g, n = plane.shape
    out = torch.zeros((npad, gpad), dtype=torch.float32, device=plane.device)
    out[:n, :g] = plane.to(torch.float32).T
    return out


def pack_inputs(ao, weights, ao_grad=None, needs_grad: bool = False):
    """One-time f32 transpose/pad of the grid-plane inputs -> (aot (npad,
    gpad), wt (gpad,), grads (3, npad, gpad) | None).  Padded rows and
    points are zero, and a zero weight removes a padded point exactly."""
    g, n = ao.shape
    npad = _npad_for(n)
    gpad = _round_up(g, CHUNK)
    aot = _pack_plane(ao, npad, gpad)
    wt = torch.zeros(gpad, dtype=torch.float32, device=ao.device)
    wt[:g] = weights.to(torch.float32)
    grads = None
    if needs_grad:
        grads = torch.stack([_pack_plane(ao_grad[k], npad, gpad)
                             for k in range(3)])
    return aot, wt, grads


def _pad_dm(dm, npad: int):
    n = dm.shape[0]
    dm_p = torch.zeros((npad, npad), dtype=torch.float32, device=dm.device)
    dm_p[:n, :n] = dm.to(torch.float32)
    return dm_p


# ---------------------------------------------------------------------------
# plain PyTorch f32 version
# ---------------------------------------------------------------------------


def functional_eval_reference(functional: Functional, rho, sigma=None):
    """(e, vrho, vsigma) in f32 with the semantics of pallas_xc.py's
    _functional_eval: floors 1e-10 / 1e-18, outputs zeroed where rho <=
    1e-10, vsigma not masked by sigma."""
    eps32 = 1e-10
    rho_s = torch.clamp(rho, min=eps32)
    live = rho > eps32
    zero = torch.zeros_like(rho)
    if functional.needs_grad:
        sig_s = torch.clamp(sigma, min=1e-18)
        e, vr, vs = value_and_potentials(functional.f, True, rho_s, sig_s)
        return (torch.where(live, e, zero), torch.where(live, vr, zero),
                torch.where(live, vs, zero))
    e, vr, _ = value_and_potentials(functional.f, False, rho_s)
    return torch.where(live, e, zero), torch.where(live, vr, zero), None


def launch_names(functional: Functional, phi_split: bool = False,
                 ablate: str = "", reduce: str = "f32") -> list[str]:
    """The LAUNCHES keys one call of this variant counts under; raises on
    a variant _make_kernel cannot build or the port does not take."""
    if reduce not in REDUCTIONS:
        raise ValueError(f"reduce must be one of {REDUCTIONS}, got {reduce!r}")
    if ablate:
        if ablate not in ABLATIONS:
            raise ValueError(f"ablate must be one of {ABLATIONS}, got "
                             f"{ablate!r}")
        if not functional.needs_grad:
            raise ValueError(f"ablation {ablate!r} exists for the GGA body "
                             f"only (pallas_xc.py), not {functional.name}")
        if phi_split or reduce != "f32":
            raise ValueError("an ablation changes one phase of K1: it takes "
                             "phi_split=False and reduce='f32'")
        return [ablate]
    names = (["K3"] if phi_split else []) + (
        ["split2"] if reduce == "split2" else [])
    return names or ["K1" if functional.needs_grad else "K2"]


def _variant_word(phi_split: bool, ablate: str, reduce: str) -> int:
    return ((_VAR_BITS["phi_split"] if phi_split else 0)
            | _VAR_BITS.get(ablate, 0)
            | (_VAR_BITS["split2"] if reduce == "split2" else 0))


def _split(x):
    """(hi, lo) = (bf16(x), bf16(x - hi)), both back in f32: pallas_xc.py's
    split.  A product of two such values is exact in f32."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def _rowsum(x, dim: int, reduce: str):
    if reduce == "split2":  # the selector matmuls: sum(hi) + sum(lo)
        hi, lo = _split(x)
        return torch.sum(hi, dim=dim) + torch.sum(lo, dim=dim)
    return torch.sum(x, dim=dim)


@contextlib.contextmanager
def _full_f32_matmul():
    """Full f32 products (no TF32) while the plain version runs."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def fused_xc_reference(functional: Functional, dm, aot, wt, grads, n: int,
                       *, phi_split: bool = False, ablate: str = "",
                       reduce: str = "f32"):
    """Plain f32 PyTorch version of K1/K2 and of each variant (see the
    module note) on packed planes -> (E_xc, V_xc) in dm's dtype."""
    launch_names(functional, phi_split, ablate, reduce)
    npad = aot.shape[0]
    with _full_f32_matmul():
        dm_p = _pad_dm(dm, npad)
        if ablate == "nophi":
            phi_d = aot
        elif phi_split or ablate == "phi3":
            dmh, dml = _split(dm_p)
            aoh, aol = _split(aot)
            phi_d = dmh @ aoh + dmh @ aol + dml @ aoh
        else:
            phi_d = dm_p @ aot                               # (npad, gpad)
        if ablate == "noprod":
            rho = _rowsum(phi_d, 0, reduce)
            gr = 2.0 * _rowsum(grads, 1, reduce)
        else:
            rho = _rowsum(phi_d * aot, 0, reduce)
            if functional.needs_grad:
                gr = 2.0 * _rowsum(grads * phi_d[None], 1, reduce)  # (3, gpad)
        if functional.needs_grad:
            sigma = torch.sum(gr * gr, dim=0)
            if ablate == "nofunc":
                e, vrho, vsigma = rho, rho, sigma
            else:
                e, vrho, vsigma = functional_eval_reference(functional, rho,
                                                            sigma)
        else:
            e, vrho, _ = functional_eval_reference(functional, rho)
        exc = _rowsum(wt * e, 0, reduce)
        if ablate == "nov":  # no B^T and no V
            v = torch.zeros((n, n), dtype=dm.dtype, device=dm.device)
        else:
            bt = (wt * vrho) * aot
            if functional.needs_grad:
                wvs = 2.0 * wt * vsigma
                bt = (bt + (wvs * gr[0]) * grads[0] + (wvs * gr[1]) * grads[1]
                      + (wvs * gr[2]) * grads[2])
            v = (aot @ bt.T)[:n, :n].to(dm.dtype)
    return exc.to(dm.dtype), 0.5 * (v + v.T)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------


def v_chunk(npad: int, gpad: int) -> int:
    """Grid points per V partial: a multiple of CHUNK chosen so that
    output tiles x chunks stays near V_BLOCKS (bounded scratch)."""
    ntile = -(-npad // TILE)
    nchunk = max(1, min(gpad // CHUNK, V_BLOCKS // (ntile * ntile)))
    return _round_up(-(-gpad // nchunk), CHUNK)


def _check_inputs(functional, dm, aot, wt, grads, n):
    npad, gpad = aot.shape
    if npad > MAX_NPAD:
        raise ValueError(
            f"fused XC kernel is checked up to npad <= {MAX_NPAD} (nao 377, "
            f"the largest molecule of the repo); got npad {npad}")
    if (not (1 <= n <= npad) or npad % 8 or gpad % CHUNK
            or tuple(dm.shape) != (n, n)):
        raise ValueError(f"bad shapes: dm {tuple(dm.shape)}, n {n}, "
                         f"aot {tuple(aot.shape)}")
    planes = [aot, wt] + ([grads] if functional.needs_grad else [])
    for t in planes:
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.device != dm.device:
            raise ValueError("packed planes must be contiguous f32 tensors "
                             "on dm's device (see pack_inputs)")
    if wt.shape != (gpad,) or (functional.needs_grad
                               and tuple(grads.shape) != (3, npad, gpad)):
        raise ValueError("weights/gradient planes do not match aot")


def _launch(functional: Functional, dm, aot, wt, grads, n: int,
            phi_split: bool, ablate: str, reduce: str):
    names = launch_names(functional, phi_split, ablate, reduce)
    _check_inputs(functional, dm, aot, wt, grads, n)
    npad, gpad = aot.shape
    dev = aot.device
    f32 = torch.float32
    dm_p = _pad_dm(dm, npad)
    chunk = v_chunk(npad, gpad)
    ldv = _round_up(npad, TILE)
    phi_bt = torch.empty((npad, gpad), dtype=f32, device=dev)
    e_part = torch.empty(gpad // POINT_BLOCK, dtype=f32, device=dev)
    v_part = torch.empty((-(-gpad // chunk), ldv, ldv), dtype=f32, device=dev)
    v_out = torch.empty((n, n), dtype=f32, device=dev)
    e_out = torch.empty(1, dtype=f32, device=dev)
    gx = gy = gz = None
    if functional.needs_grad:
        gx, gy, gz = grads[0], grads[1], grads[2]
    with torch.cuda.device(dev):
        code = _lib().fused_xc(
            functional.kind, _variant_word(phi_split, ablate, reduce), n,
            npad, gpad, chunk, _ptr(dm_p), _ptr(aot), _ptr(gx), _ptr(gy),
            _ptr(gz), _ptr(wt), _ptr(phi_bt), _ptr(e_part), _ptr(v_part),
            _ptr(v_out), _ptr(e_out), _stream())
    _check(code, "fused_xc launch")
    for name in names:
        LAUNCHES[name] += 1
    return e_out[0].to(dm.dtype), v_out.to(dm.dtype)


def fused_xc(functional: Functional, dm, aot, wt, grads, n: int, *,
             phi_split: bool = False, ablate: str = "", reduce: str = "f32"):
    """XC build from packed planes (pack_inputs) -> (E_xc, V_xc) in dm's
    dtype.  CUDA tensors launch the kernel of the variant (K1/K2 with no
    keyword); CPU tensors run the plain version."""
    if aot.is_cuda:
        return _launch(functional, dm, aot, wt, grads, n, phi_split, ablate,
                       reduce)
    return fused_xc_reference(functional, dm, aot, wt, grads, n,
                              phi_split=phi_split, ablate=ablate,
                              reduce=reduce)


def xc_step_fused(functional: Functional, dm, ao, weights, ao_grad=None, *,
                  phi_split: bool = False, ablate: str = "",
                  reduce: str = "f32"):
    """Unpacked entry with the xc_step contract (packs on every call; the
    port of xc_step_pallas, whose phi_split it takes)."""
    aot, wt, grads = pack_inputs(ao, weights, ao_grad,
                                 needs_grad=functional.needs_grad)
    return fused_xc(functional, dm, aot, wt, grads, dm.shape[0],
                    phi_split=phi_split, ablate=ablate, reduce=reduce)


def functional_eval(functional: Functional, rho, sigma=None):
    """The kernels' f32 functional alone: on CUDA tensors through the
    device code of csrc/xc_functional.cuh, on CPU tensors the plain
    version.  -> (e, vrho, vsigma)."""
    if not rho.is_cuda:
        return functional_eval_reference(functional, rho, sigma)
    rho = rho.to(torch.float32).contiguous()
    sig = None if sigma is None else sigma.to(torch.float32).contiguous()
    e, vr, vs = (torch.empty_like(rho) for _ in range(3))
    with torch.cuda.device(rho.device):
        code = _lib().xc_functional_eval(
            functional.kind, rho.numel(), _ptr(rho), _ptr(sig), _ptr(e),
            _ptr(vr), _ptr(vs), _stream())
    _check(code, "xc_functional_eval launch")
    return e, vr, (vs if functional.needs_grad else None)
