"""Fused f32 XC build on Hopper: the port of engine/pallas_xc.py.

Kernels K1 (GGA body: PBE, B3LYP) and K2 (LDA body: LDA, and HF through
the zero functional) are hand-written CUDA C++ for sm_90a in
``csrc/fused_xc.cu`` (design, bounds and reduction scheme in its header
note).  They replace ``quantum_compute_dft_tpu/engine/pallas_xc.py::
_make_kernel``, and so do the variants that factory can build, chosen by
keyword (arguments, not environment variables, so one process can run
them all):

  * ``phi_split=True``: K3, phi_D as the 3-pass bf16 split on the tensor
    cores (``_make_kernel(phi_split=True)``), either body, in the rho
    kernel of K1 and K2;
  * ``ablate=``: the GGA body with one phase stubbed (``_ENV_ABLATE``):
    "nophi" (phi_D := AO), "phi3" (phi_D through K3), "noprod" (row sums
    without the products), "nofunc" (e = rho, vrho = rho, vsigma = sigma),
    "nov" (no B^T and no V: V = 0).  Wrong results by design: they exist
    to attribute the kernel's time to its phases (nophi, phi3 and nov run
    K1's kernels, so K1 minus each is the time of what it removes);
  * ``reduce="split2"``: the Pallas default's 2-pass bf16 row sums of rho,
    grad rho and E; the default "f32" is ``_ENV_VPU_REDUCE``'s plain sum.

K1 and K2 (the GGA and LDA bodies with no variant, replacing
``pallas_xc.py:201-265`` and ``:269-291``) have a design of their own for
Hopper (``csrc/fused_xc.cu``'s header note), one C entry (``fused_xc_tc``)
of three kernels, which K3 (either body, without split2) and the ablations
phi3 (K3's GGA body), nophi and nov share, each with a mode word of its own
(``route``):

  * ``xc_rho_kernel`` (or, where D fits in shared memory, npad <= 176 for
    K2 and <= 168 for K1, the persistent ``xc_rho_res_kernel``): phi_D on
    the tensor cores for a 64-point tile and every mu, rho (K1: and grad
    rho, against the gradient planes read once) from the accumulators, the
    functional, s = w vrho (K1: u_k = c w vsigma grad_k rho with c the
    functional's ``sigma_factor``: 4, so that V_xc = dE_xc/dD, or 2 under
    ``jax_potential()``, the JAX package's factor) and
    the tile's E partial; phi_D never leaves registers;
  * V over the 32 x 32 tiles on or above the diagonal, split-K over grid
    chunks: K2's ``xc_lda_v_kernel`` (V = AO diag(s) AO^T, s AO formed at
    fragment load; schedule ``lda_v_tiles``/``lda_v_chunk``), K1's
    ``xc_gga_v_kernel`` (V + V^T = AO B^T + B AO^T with B = s AO + sum_k u_k
    dAO_k formed slab by slab in shared memory, the planes streamed in by a
    producer warpgroup; its chunk from the C query ``fused_xc_tc_v_chunk``,
    which knows the schedule and the device's SMs); no B^T plane exists;
  * the deterministic reduce, which mirrors the upper triangle (K1: and
    halves it).

For K1 and K2 both products are 3 x TF32 (hi = tf32(x), lo = x - hi;
hi.lo + lo.hi + hi.hi with f32 sums): f32-class, as the TPU kernel's phi_D
at HIGHEST, since a coarser phi_D costs SCF cycles
(``pallas_xc.py:131-141``).  K3 and phi3 form phi_D as ``mm_phi`` does,
the 3-pass bf16 split (D_h AO_h + D_h AO_l + D_l AO_h, f32 sums) on
m16n8k16 bf16 ``mma.sync``, D split once per call, and then run K1's and
K2's fold, functional, V and reduce as they are.  nophi runs K1's
kernels with no product (the rho kernel fills its accumulators from the
staged AO tile; no density is read), nov K1's rho kernel and the E sum
with no V kernel (V written as zeros).  The old design (FP32 FMA tiles,
phi_D and B^T planes in HBM, all of V) measured 5.4-5.8 ms (K1) and
4.5-5.0 ms (K2) at DHA; it stays as the four-kernel pipeline of K1base
(``base=True``: K1 on it, the base noprod, nofunc and split2 are read
against in ``tools/torch_xc_sweep.py``), the ablations noprod and nofunc,
split2, and K3 with split2.  What bounds the new kernels is in the header
note and ``PERF.md``.

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
import functools
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
TILE = 64         # output tile edge of K1's (and the variants') products
# target (output tiles x grid chunks) blocks of the V partial kernel: the
# chunk grows with npad so that the partial buffer stays ~V_BLOCKS * 16 KB
V_BLOCKS = 2048
# K1 and K2 (csrc/fused_xc.cu, fused_xc_tc): points per rho block (its E
# partials), the V output tile edge; K2's V tiles per block (one a warp),
# the target block count of its V kernel (two waves of the H100's 132 SMs)
# and the bound on its chunk partials (floats, 32 MB; K1's chunk comes from
# the C side)
RHO_COLS = 64
LDA_V_TILE = 32
LDA_V_WARPS = 16
LDA_V_BLOCKS = 264
LDA_V_PART_FLOATS = 8 << 20

ABLATIONS = ("nophi", "phi3", "noprod", "nofunc", "nov")
REDUCTIONS = ("f32", "split2")
# the variant word of the four-kernel entry (csrc/fused_xc.cu's k* constants)
_VAR_BITS = {"phi_split": 1, "noprod": 4, "nofunc": 8, "split2": 32}
# the mode word of fused_xc_tc (csrc/fused_xc.cu): the rho kernels' product
# (kTf32x3: 3 x TF32; kBf16x3: the 3-pass bf16 split; kPhiAo: none, phi_D
# := AO), and kTcNoV, no V kernel (V = 0)
TF32X3, BF16X3, PHI_AO, NO_V = 0, 1, 2, 4
# the variants fused_xc_tc runs, by launch name -> mode word
_TC_MODES = {"K1": TF32X3, "K2": TF32X3, "K3": BF16X3, "phi3": BF16X3,
             "nophi": PHI_AO, "nov": TF32X3 | NO_V}

# each variant alone, by the LAUNCHES name it counts under -> the keywords
# of fused_xc (K1: none; K1base: K1 on the four-kernel pipeline, the
# base of noprod and nofunc; tools/torch_xc_sweep.py times them all)
VARIANTS = {"K1": {}, "K1base": {"base": True}, "K3": {"phi_split": True},
            **{a: {"ablate": a} for a in ABLATIONS},
            "split2": {"reduce": "split2"}}

# kernel launches, counted by the wrapper where it launches: K1 (GGA body)
# and K2 (LDA body) with no variant; a variant counts under its own names
# instead (K1base, K3 for phi_split, the ablation's name, split2)
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
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit to build")


def _library_path(stem: str, sources: tuple, flags: tuple = ()) -> Path:
    h = hashlib.sha256()
    for name in sources:
        h.update((_CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def build_library(stem: str, sources: tuple, flags: tuple = ()) -> Path:
    """Compile csrc/<sources[0]> (which includes the rest of `sources`)
    with NVCC_FLAGS + flags into BUILD_DIR/<stem>_<hash>.so unless the
    library for this source and flag hash exists; returns its path."""
    out = _library_path(stem, sources, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp, str(_CSRC / sources[0])]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def library_path() -> Path:
    return _library_path("fused_xc", _SOURCES)


def build() -> Path:
    """Compile csrc/fused_xc.cu unless the library for this source hash
    exists; returns its path."""
    return build_library("fused_xc", _SOURCES)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_xc.argtypes = [i] * 6 + [p] * 11 + [f, p]
        lib.fused_xc.restype = i
        lib.fused_xc_tc.argtypes = [i] * 6 + [p] * 13 + [f, p]
        lib.fused_xc_tc.restype = i
        lib.fused_xc_tc_v_chunk.argtypes = [i, i]
        lib.fused_xc_tc_v_chunk.restype = i
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


def _on(dev):
    """dev as the current device for a launch (no switch when it is)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


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
                 ablate: str = "", reduce: str = "f32",
                 base: bool = False) -> list[str]:
    """The LAUNCHES keys one call of this variant counts under; raises on
    a variant _make_kernel cannot build or the port does not take."""
    if reduce not in REDUCTIONS:
        raise ValueError(f"reduce must be one of {REDUCTIONS}, got {reduce!r}")
    if base:
        if not functional.needs_grad:
            raise ValueError("base=True is K1 on the four-kernel pipeline: "
                             f"the GGA body only, not {functional.name}")
        if phi_split or ablate or reduce != "f32":
            raise ValueError("base=True is K1 on the four-kernel pipeline "
                             "and takes no other variant")
        return ["K1base"]
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


def route(functional: Functional, phi_split: bool = False, ablate: str = "",
          reduce: str = "f32", base: bool = False) -> tuple[str, object]:
    """Which C entry runs a variant: ("tc", mode word) for fused_xc_tc,
    K1/K2 with the 3 x TF32 product (TF32X3), K3 (without split2) and phi3
    with the 3-pass bf16 split (BF16X3), nophi with no product (PHI_AO) and
    nov with no V (TF32X3 | NO_V); ("pipeline", variant word) for
    fused_xc's four kernels: K1base, noprod, nofunc, split2 and K3 with
    split2.  Raises as launch_names does."""
    names = launch_names(functional, phi_split, ablate, reduce, base)
    if len(names) == 1 and names[0] in _TC_MODES:
        return "tc", _TC_MODES[names[0]]
    return "pipeline", _variant_word(phi_split, ablate, reduce)


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
                       reduce: str = "f32", base: bool = False):
    """Plain f32 PyTorch version of K1/K2 and of each variant (see the
    module note; K1base computes what K1 does) on packed planes -> (E_xc,
    V_xc) in dm's dtype, V_xc under the functional's sigma_factor."""
    launch_names(functional, phi_split, ablate, reduce, base)
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
                wvs = functional.sigma_factor * wt * vsigma
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


def lda_v_tiles(npad: int) -> list[list[tuple[int, int]]]:
    """K2's V schedule: the 32 x 32 output tiles (row, col) on or above
    the diagonal, row by row, in blocks of LDA_V_WARPS (one tile a warp;
    xc_lda_v_kernel's upper_tile enumerates the same order)."""
    t = -(-npad // LDA_V_TILE)
    tiles = [(r, c) for r in range(t) for c in range(r, t)]
    return [tiles[i:i + LDA_V_WARPS]
            for i in range(0, len(tiles), LDA_V_WARPS)]


@functools.lru_cache(maxsize=None)
def lda_v_chunk(npad: int, gpad: int) -> int:
    """Grid points per K2 V partial: a multiple of 32 (the kernel's
    slab) with tile blocks x chunks near LDA_V_BLOCKS and the partials
    (nchunk ldv^2 floats) within LDA_V_PART_FLOATS."""
    ldv = -(-npad // LDA_V_TILE) * LDA_V_TILE
    nslab = gpad // 32
    nchunk = max(1, min(nslab, LDA_V_BLOCKS // len(lda_v_tiles(npad)),
                        LDA_V_PART_FLOATS // (ldv * ldv)))
    return 32 * -(-nslab // nchunk)


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
            phi_split: bool, ablate: str, reduce: str, base: bool):
    names = launch_names(functional, phi_split, ablate, reduce, base)
    _check_inputs(functional, dm, aot, wt, grads, n)
    entry, arg = route(functional, phi_split, ablate, reduce, base)
    if entry == "tc":
        return _launch_tc(functional, dm, aot, wt, grads, n, names[0], arg)
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
    with _on(dev):
        code = _lib().fused_xc(
            functional.kind, arg, n,
            npad, gpad, chunk, _ptr(dm_p), _ptr(aot), _ptr(gx), _ptr(gy),
            _ptr(gz), _ptr(wt), _ptr(phi_bt), _ptr(e_part), _ptr(v_part),
            _ptr(v_out), _ptr(e_out), functional.sigma_factor, _stream())
    _check(code, "fused_xc launch")
    for name in names:
        LAUNCHES[name] += 1
    return e_out[0].to(dm.dtype), v_out.to(dm.dtype)


def _launch_tc(functional: Functional, dm, aot, wt, grads, n: int,
               name: str, mode: int):
    """K1/K2 (mode TF32X3), K3/phi3 (BF16X3), nophi (PHI_AO) and nov
    (TF32X3 | NO_V): the density's f32 copy (or its bf16 hi and lo planes;
    none for nophi), xc_rho(_res)_kernel, xc_gga_v_kernel (GGA body; not
    for nov) or xc_lda_v_kernel (LDA body), and the reduce, which writes E
    and V in f64; counted under `name`.  As little as possible runs on the
    host before the first launch."""
    npad, gpad = aot.shape
    dev, f32 = aot.device, torch.float32
    gga = functional.needs_grad
    if gga:  # the C side knows K1's V schedule and the device's SMs
        with _on(dev):
            chunk = _lib().fused_xc_tc_v_chunk(npad, gpad)
        _check(max(0, -chunk), "fused_xc_tc_v_chunk")
    else:
        chunk = lda_v_chunk(npad, gpad)
    ldv = -(-npad // LDA_V_TILE) * LDA_V_TILE
    uses_dm = mode != PHI_AO
    dm64 = dm.to(torch.float64).contiguous() if uses_dm else None
    # one scratch allocation: dm_p (npad, npad; in mode BF16X3 the hi and
    # lo bf16 planes in the same bytes; none for nophi), s (gpad), u (3,
    # gpad) for the GGA body, the E partials (gpad / 64), the V partials
    # (nchunk, ldv, ldv; none for nov); every piece is a multiple of 4
    # floats, so each starts 16-byte aligned
    nv = 0 if mode & NO_V else -(-gpad // chunk) * ldv * ldv
    sizes = (npad * npad if uses_dm else 0, gpad, 3 * gpad if gga else 0,
             gpad // RHO_COLS, nv)
    scratch = torch.empty(sum(sizes), dtype=f32, device=dev)
    ptrs, at = [], scratch.data_ptr()
    for size in sizes:
        ptrs.append(at if size else None)
        at += 4 * size
    dm_p, s, u, e_part, v_part = ptrs
    v_out = torch.empty((n, n), dtype=torch.float64, device=dev)
    e_out = torch.empty(1, dtype=torch.float64, device=dev)
    gx = gy = gz = None
    if gga:
        gx, gy, gz = grads[0], grads[1], grads[2]
    with _on(dev):
        code = _lib().fused_xc_tc(
            functional.kind, mode, n, npad, gpad, chunk,
            _ptr(dm64), dm_p,
            _ptr(aot), _ptr(gx), _ptr(gy), _ptr(gz), _ptr(wt), s, u,
            e_part, v_part, _ptr(v_out), _ptr(e_out),
            functional.sigma_factor, _stream())
    _check(code, "fused_xc_tc launch")
    LAUNCHES[name] += 1
    return e_out[0].to(dm.dtype), v_out.to(dm.dtype)


def fused_xc(functional: Functional, dm, aot, wt, grads, n: int, *,
             phi_split: bool = False, ablate: str = "", reduce: str = "f32",
             base: bool = False):
    """XC build from packed planes (pack_inputs) -> (E_xc, V_xc) in dm's
    dtype.  CUDA tensors launch the kernels of the variant (K1/K2 with no
    keyword); CPU tensors run the plain version.  V_xc is under the
    functional's sigma_factor (the GGA body's u_k at c w vsigma)."""
    if aot.is_cuda:
        return _launch(functional, dm, aot, wt, grads, n, phi_split, ablate,
                       reduce, base)
    return fused_xc_reference(functional, dm, aot, wt, grads, n,
                              phi_split=phi_split, ablate=ablate,
                              reduce=reduce, base=base)


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
