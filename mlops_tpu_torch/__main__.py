"""``python -m mlops_tpu_torch`` — the CLI entry point."""

import sys

from mlops_tpu_torch.cli import main

sys.exit(main())
