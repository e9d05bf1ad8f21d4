"""The traffic-shape autotuner, the port of the JAX package's
``autotune/``: the closed loop that regrids the serving plane from its
own telemetry.

- ``costmodel.py`` (torch-free) fits a measured per-entry dispatch cost
  model from the device-time cost ledger (``slo/ledger.py``);
- ``search.py`` (torch-free) searches candidate bucket grids against the
  observed requested-rows histogram (``trace/shapes.py``) and emits the
  winner as a plan;
- ``apply.py`` captures the plan's missing CUDA graphs off the request
  path and exchanges the engine's grid in one reference swap
  (``InferenceEngine.warm_grid`` / ``regrid``).

Runs as the in-process ``AutotuneController`` (``autotune.enabled``) or
one-shot offline via ``python -m mlops_tpu_torch autotune`` (ledger +
spans in, plan out, ``lifecycle``-style exit codes).
"""

from mlops_tpu_torch.autotune.costmodel import (  # noqa: F401
    CostModel,
    demand_from_shapes,
    demand_from_spans,
    fit_cost_model,
    ledger_rows_from_snapshot,
)
from mlops_tpu_torch.autotune.search import GridPlan, search_plan  # noqa: F401
from mlops_tpu_torch.autotune.apply import (  # noqa: F401
    AutotuneController,
    apply_plan,
    warm_plan,
)
