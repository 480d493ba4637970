from quantum_compute_dft_tpu_torch.xc.functionals import (  # noqa: F401
    B3LYP,
    FUNCTIONALS,
    GGA,
    HF,
    LDA,
    Functional,
)
