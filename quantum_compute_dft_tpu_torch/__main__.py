import sys

from quantum_compute_dft_tpu_torch.cli import main

sys.exit(main())
