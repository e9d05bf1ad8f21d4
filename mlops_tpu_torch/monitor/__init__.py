"""Monitor state and the serving accumulator."""

from mlops_tpu_torch.monitor.state import (
    MonitorAccumulator,
    MonitorState,
    fit_monitor,
    fold_accumulator,
    fold_accumulator_grouped,
    init_accumulator,
)

__all__ = [
    "MonitorAccumulator",
    "MonitorState",
    "fit_monitor",
    "fold_accumulator",
    "fold_accumulator_grouped",
    "init_accumulator",
]
