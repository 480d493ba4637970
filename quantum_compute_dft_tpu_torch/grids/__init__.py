from quantum_compute_dft_tpu_torch.grids.builder import (  # noqa: F401
    Grid,
    build_grid,
    load_grid_file,
)
