from quantum_compute_dft_tpu_torch.grids.builder import Grid, build_grid  # noqa: F401
