from quantum_compute_dft_tpu_torch.basis.basis_set import BasisSet, Shell, build_basis  # noqa: F401
from quantum_compute_dft_tpu_torch.basis.data import ZETA, UNIVERSAL_FITS, element_shells  # noqa: F401
