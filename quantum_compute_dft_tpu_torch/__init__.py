"""PyTorch/CUDA port of the restricted Kohn-Sham DFT framework.

The counterpart of ``quantum_compute_dft_tpu`` (the JAX reference, which
stays as it is) for an NVIDIA Hopper card.  Same subpackage layout and
function names, so each module's reference is found by path:

    mol/        XYZ parsing, elements, nuclear repulsion     (copied, numpy)
    basis/      STO-3G tables, basis construction, SAD guess (copied, numpy)
    integrals/  McMurchie-Davidson S, T, V, ERI in torch f64; the
                pivoted-Cholesky ERI factor and density-fitted J/K
    grids/      Becke molecular grids (radial/angular copied, Becke in torch)
    xc/         LDA/GGA/B3LYP functionals, potentials by torch.autograd
    engine/     AO evaluation, f64 XC engine, J/K, and the fused f32 XC
                kernel written in CUDA for sm_90a (engine/fused_xc.py +
                csrc/fused_xc.cu)
    scf/        CDIIS and the host SCF loops (f64 and the 'fast' schedule)
    kohn_sham   prepare/run, setup_from_arrays
    cli         ``python -m quantum_compute_dft_tpu_torch {LDA,GGA,B3LYP} <Mol>``

Every tensor of the SCF is float64 except the fused XC kernel's f32 work
and the density-fitted f32 K of the 'fast' schedule's kernel phase.
TF32 would silently cut f32 matrix products to ~10 mantissa bits, so it is
switched off here for the whole package, explicitly, rather than relying
on the PyTorch default.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
