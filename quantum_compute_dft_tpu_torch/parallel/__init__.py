from quantum_compute_dft_tpu_torch.parallel.mesh import (  # noqa: F401
    Shard,
    grid_group,
    pad_to_multiple,
    shard_grid_arrays,
)
from quantum_compute_dft_tpu_torch.parallel.sharded import (  # noqa: F401
    sharded_df_builders,
    sharded_fock_builders,
    sharded_xc_step,
)
