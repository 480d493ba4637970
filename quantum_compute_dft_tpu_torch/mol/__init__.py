from quantum_compute_dft_tpu_torch.mol.molecule import (  # noqa: F401
    Molecule,
    from_atoms,
    from_xyz_file,
    from_xyz_text,
)
from quantum_compute_dft_tpu_torch.mol.xyz import (  # noqa: F401
    load_xyz,
    load_xyz_as_string,
    parse_xyz_text,
)
