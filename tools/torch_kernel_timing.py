"""Kernel timing on the card and the fused XC kernels' bound.

    import torch_kernel_timing as kt
    ms = kt.cuda_ms(fn)                       # median of 25 CUDA-event calls
    bound_ms, by, *_ = kt.xc_bound("K1", needs_grad=True, n=152, npts=npts)
    head = kt.card("cuda")      # {"device", "gpu", "power_limit", ...}

Shared by chip_smoke.py and the port's tools.  Imports torch only inside
cuda_ms and card.
"""

from __future__ import annotations

import statistics
import subprocess

# the card's peaks for the bounds (H100 SXM data sheet, 700 W): HBM bytes/s
# and the tensor-core rates (TF32; bf16 dense for the products K3 and phi3
# form as the 3-pass bf16 split), at which the product FLOPs are counted;
# the FP32 pipe's rate, reported beside them
HBM_BYTES_S = 3.35e12
TF32_FLOP_S = 495e12
BF16_FLOP_S = 989e12
FP32_FLOP_S = 67e12
# the rows whose phi_D is the bf16 split
BF16_PHI = ("K3", "phi3")


def cuda_ms(fn, reps: int = 25, warm: int = 3) -> float:
    """Median ms of `reps` calls of fn, each between two CUDA events, after
    `warm` untimed calls."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card(device: str) -> dict:
    """The device a tool runs on, for its output's header: on cuda the
    card's name and power limit as nvidia-smi gives them (and SystemExit
    when there is no CUDA device: the CPU runs only when asked for)."""
    import torch

    head = {"device": device, "gpu": None, "power_limit": None,
            "torch": torch.__version__}
    if device == "cpu":
        return head
    if not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {device}; "
                         "--device cpu runs on the CPU")
    name, power = (x.strip() for x in subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].split(","))
    return dict(head, gpu=name, power_limit=power, cuda=torch.version.cuda)


def xc_bound(kid: str, needs_grad: bool, n: int, npts: int):
    """The least time the card could take for one fused XC call, counted on
    the n AOs and npts grid points (the wrapper's padding to npad rows and
    gpad points is not work the function needs).  Bytes: each input read
    once (the f64 D, the f32 AO plane and for the GGA body its three
    gradient planes, the f32 weights) and each output written once (the
    f64 V and E), at HBM_BYTES_S.  Operations: the products the variant
    computes, on the tensor cores: phi_D = D AO, 2 n^2 npts FLOPs, at the
    TF32 rate, or for K3 and phi3 (the bf16 split) at the bf16 rate; V,
    symmetric, a syr2k (AO B^T + B AO^T) of 2 n^2 npts FLOPs for the GGA
    body and a syrk (AO diag(s) AO^T) of n (n + 1) npts for the LDA body,
    at the TF32 rate; the ablation nophi drops phi_D, nov drops V.
    -> (ms, "bytes" | "operations", bytes ms, tensor-core ops ms, the same
    FLOPs' ms on the FP32 pipe)."""
    planes = 4 if needs_grad else 1
    nbytes = 8 * (2 * n * n + 1) + 4 * (planes * n + 1) * npts
    phi = 0.0 if kid == "nophi" else 2.0 * n * n * npts
    v = 0.0
    if kid != "nov":
        v = (2.0 * n * n if needs_grad else n * (n + 1.0)) * npts
    t_b = nbytes / HBM_BYTES_S
    t_o = (phi / (BF16_FLOP_S if kid in BF16_PHI else TF32_FLOP_S)
           + v / TF32_FLOP_S)
    return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations",
            1e3 * t_b, 1e3 * t_o, 1e3 * (phi + v) / FP32_FLOP_S)
