"""ctypes binding for the native host engine (runtime/dft_host.cpp).

Port of ``quantum_compute_dft_tpu/runtime/ffi.py``, which mirrors the
reference's ``DFTSolverWrapper`` (ref dft.py:15-95): the same C ABI, the
same argtypes, pointers marshalled as uint64, over host numpy arrays.
dft_host.cpp is the JAX package's file but for its V_xc, which is
dE_xc/dD (the JAX package's has half the sigma term, which
``sigma_factor=2.0`` reproduces through ``DFT_SetSigmaFactor``); the library
is built from this package's copy with g++ on first use, into the
repository's build/ directory (never into the package), under a name
carrying the source hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "dft_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "runtime"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


def library_path() -> str:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return str(BUILD_DIR / f"libdft_host_{h.hexdigest()[:16]}.so")


def build_library(force: bool = False) -> str:
    """Compile dft_host.cpp unless the library for this source hash
    exists; returns its path.  The compiler writes a temporary file that is
    renamed into place, so concurrent builders never load a partial one."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


class HostSolverWrapper:
    """Drop-in analog of the reference DFTSolverWrapper over host memory."""

    TYPE_LDA = 0
    TYPE_GGA = 1
    TYPE_B3LYP = 2

    def __init__(self, functional_type: str = "LDA",
                 lib_path: str | None = None, sigma_factor: float = 4.0):
        lib_path = lib_path or build_library()
        self.lib = ctypes.CDLL(os.path.abspath(lib_path))
        self.lib.DFT_CreateSolver.argtypes = [ctypes.c_int]
        self.lib.DFT_CreateSolver.restype = ctypes.c_void_p
        self.lib.DFT_DestroySolver.argtypes = [ctypes.c_void_p]
        self.lib.DFT_DestroySolver.restype = None
        self.lib.DFT_ComputeXC.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint64,
        ]
        self.lib.DFT_ComputeXC.restype = ctypes.c_double
        self.lib.DFT_ComputeCoulomb.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ]
        self.lib.DFT_ComputeCoulomb.restype = None
        self.lib.DFT_SetSigmaFactor.argtypes = [ctypes.c_void_p,
                                                ctypes.c_double]
        self.lib.DFT_SetSigmaFactor.restype = None

        kind = {"LDA": 0, "GGA": 1, "PBE": 1,
                "B3LYP": 2}[functional_type.upper()]
        self.solver = self.lib.DFT_CreateSolver(kind)
        if not self.solver:
            raise RuntimeError("failed to create native host solver")
        # the factor of w vsigma grad-rho . grad-phi in B (dft_host.cpp)
        self.lib.DFT_SetSigmaFactor(self.solver, sigma_factor)

    def __del__(self):
        if getattr(self, "solver", None):
            self.lib.DFT_DestroySolver(self.solver)
            self.solver = None

    @staticmethod
    def _ptr(a: np.ndarray) -> ctypes.c_uint64:
        assert a.flags["C_CONTIGUOUS"] and a.dtype == np.float64
        return ctypes.c_uint64(a.ctypes.data)

    def compute_xc(self, dm, ao, weights, vxc, ao_grad=None):
        ngrid, nao = ao.shape
        grad_ptr = (self._ptr(ao_grad) if ao_grad is not None
                    else ctypes.c_uint64(0))
        return self.lib.DFT_ComputeXC(
            self.solver, ngrid, nao,
            self._ptr(dm), self._ptr(ao), grad_ptr,
            self._ptr(weights), self._ptr(vxc),
        )

    def compute_coulomb(self, eri2d, dm, out):
        nao = dm.shape[0]
        self.lib.DFT_ComputeCoulomb(
            self.solver, nao, self._ptr(eri2d), self._ptr(dm), self._ptr(out)
        )
