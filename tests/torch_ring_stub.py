"""The ring plane with a stub engine, for the plane tests that need an
engine they can hold: ``python tests/torch_ring_stub.py key=value ...``
takes ``serve`` overrides and runs ``serve_multi_worker`` with
``SlowStubEngine`` in the engine process. The environment sets it:

- ``STUB_DELAY_S``: seconds each dispatch's fetch takes (default 0.5);
- ``STUB_TIERS``: ``exact`` (default) or ``quant,exact``;
- ``STUB_RESPAWN_WARMUP_S``: seconds a respawned engine's warmup takes
  (the first engine's takes none), with ``STUB_MARK`` the file that tells
  a respawn from the first boot.

The stub answers every row 0.25, flags 0 and drift 0, and needs neither
torch nor a bundle's weights.
"""

import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mlops_tpu_torch.config import load_config  # noqa: E402
from mlops_tpu_torch.serve.frontend import serve_multi_worker  # noqa: E402
from mlops_tpu_torch.serve.tierroute import TIERS, tier_for_class  # noqa: E402


class SlowStubEngine:
    supports_grouping = False
    default_tier = serve_tier = "exact"
    device = "cpu"

    def __init__(self) -> None:
        self.delay_s = float(os.environ.get("STUB_DELAY_S", "0.5"))
        held = os.environ.get("STUB_TIERS", "exact").split(",")
        self.available_tiers = tuple(t for t in TIERS if t in held)
        self._counts: dict[str, int] = {}

    def warmup(self) -> None:
        mark = Path(os.environ.get("STUB_MARK", "/nonexistent/stub-mark"))
        if mark.parent.is_dir():
            if mark.exists():
                time.sleep(float(os.environ.get("STUB_RESPAWN_WARMUP_S", "0")))
            mark.touch()

    def route_tier(self, slo_class: int):
        tier = tier_for_class(self.available_tiers, self.default_tier, slo_class)
        return None if tier == self.default_tier else tier

    def dispatch_arrays(self, cat, num, tier=None):
        label = f"bucket_{cat.shape[0]}" + (f"@{tier}" if tier else "")
        self._counts[label] = self._counts.get(label, 0) + 1
        return cat.shape[0]

    def fetch_arrays_raw(self, n):
        time.sleep(self.delay_s)
        return np.full(n, 0.25), np.zeros(n), np.zeros(23)

    def dispatch_counts(self) -> dict[str, int]:
        return dict(self._counts)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    config = load_config(sys.argv[1:])
    bundle = config.serve.model_directory
    sys.exit(serve_multi_worker(config, bundle, make_engine=lambda *_: SlowStubEngine()))
