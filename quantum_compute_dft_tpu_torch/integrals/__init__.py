from quantum_compute_dft_tpu_torch.integrals.boys import boys, boys_fast  # noqa: F401
from quantum_compute_dft_tpu_torch.integrals.one_electron import one_electron  # noqa: F401
from quantum_compute_dft_tpu_torch.integrals.two_electron import eri_full, eri_packed  # noqa: F401
