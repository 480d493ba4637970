from quantum_compute_dft_tpu_torch.engine.ao_eval import eval_ao  # noqa: F401
from quantum_compute_dft_tpu_torch.engine.coulomb import (  # noqa: F401
    coulomb_full,
    exchange_full,
)
from quantum_compute_dft_tpu_torch.engine.xc_engine import xc_energy, xc_step  # noqa: F401
