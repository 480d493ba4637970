from quantum_compute_dft_tpu_torch.scf.checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from quantum_compute_dft_tpu_torch.scf.diis import DIISState, diis_init, diis_update  # noqa: F401
from quantum_compute_dft_tpu_torch.scf.driver import (  # noqa: F401
    SCFResult,
    SCFSystem,
    energy_of_dm,
    initial_guess,
    make_system,
    s_inv_sqrt,
    scf_host,
    scf_host_annealed,
    scf_iteration,
)
