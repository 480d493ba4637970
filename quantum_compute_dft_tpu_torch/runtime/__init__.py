"""The native C++ host engine (dft_host.cpp) and the SCF that drives it:
an engine written apart from the port's torch path, used as the
end-of-run oracle (``--validate native``)."""

from quantum_compute_dft_tpu_torch.runtime.ffi import (  # noqa: F401
    HostSolverWrapper,
    build_library,
    library_path,
)
from quantum_compute_dft_tpu_torch.runtime.native_scf import (  # noqa: F401
    run_native_scf,
)
