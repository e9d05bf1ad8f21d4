"""Optional TensorBoard event writer for training metrics: a copy of the
JAX package's ``utils/tboard.py``. ``metrics.jsonl`` stays the store of
record; with ``train.tensorboard_dir`` set the same records also stream
into event files through torch's ``SummaryWriter``. If that writer cannot
be built, it warns once and does nothing, and training goes on.
"""

from __future__ import annotations

import warnings
from pathlib import Path


class TensorBoardWriter:
    """Scalar-event writer; constructible even when tensorboard is absent."""

    def __init__(self, logdir: str | Path):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=str(logdir))
        # Any import/init failure (torch absent, incompatible protobuf,
        # unwritable logdir) -> warn-and-no-op; metrics still reach jsonl.
        except Exception as err:
            warnings.warn(
                f"tensorboard writer unavailable ({err}); metrics go to "
                "metrics.jsonl only",
                stacklevel=2,
            )

    def write(self, record: dict) -> None:
        """Log every numeric field of a metrics record at its 'step'."""
        if self._writer is None:
            return
        step = int(record.get("step", 0))
        for key, value in record.items():
            if key == "step" or not isinstance(value, (int, float)):
                continue
            self._writer.add_scalar(key, float(value), global_step=step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
