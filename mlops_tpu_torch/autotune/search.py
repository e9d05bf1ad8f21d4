"""Grid search: the bucket set that maximizes goodput on observed traffic.

A copy of the JAX package's ``autotune/search.py``, torch-free: a plan
either package writes loads in the other. Given the fitted cost model (autotune/costmodel.py) and the
observed requested-rows demand, pick the bucket set that minimizes total
predicted device time — equivalently maximizes predicted
``useful_rows_per_s`` (ML-fleet goodput accounting: useful rows over
device seconds, padding is pure waste).

The search is EXACT, not heuristic: for a fixed affine cost model the
optimal bucket set's members always coincide with observed demand sizes
(lowering any bucket to the largest demand size it serves never raises
any dispatch's cost), so the space collapses to "choose <= max_entries
boundaries among the distinct observed sizes" — a classic O(k·n²)
dynamic program over sorted sizes, exact in milliseconds at telemetry
cardinalities (the occupancy table bounds n).

Constraints honored here, not re-litigated:
- the plan never shrinks shape coverage: the live ``max_bucket`` stays
  in every candidate set (the admission ceiling engines/front ends
  clamped against at start — `InferenceEngine.regrid` enforces the
  same floor);
- ``max_entries`` is the capture budget (each solo bucket is one CUDA
  graph per tier, captured at warm time);
- group geometries / ``pipeline_depth`` / batch windows ride the plan
  as ADVISORY fields only (`ServeConfig.validate` stays the arbiter for
  anything an operator applies by restart; the hot path applies bucket
  sets only).
"""

from __future__ import annotations

import dataclasses

from mlops_tpu_torch.autotune.costmodel import CostModel

PLAN_FORMAT = 1  # plan.json schema version (replica adoption contract)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """One searched grid: the warmup plan plus its predicted economics
    (the predicted-vs-measured audit's "predicted" half)."""

    buckets: tuple[int, ...]
    baseline_buckets: tuple[int, ...]
    predicted_rows_per_s: float  # useful rows per device-second, new grid
    baseline_rows_per_s: float  # ... on the baseline (live) grid
    predicted_gain_pct: float
    predicted_waste_pct: float
    baseline_waste_pct: float
    demand_dispatches: float  # total dispatch weight the search saw
    cost_model: dict  # CostModel.as_dict()

    def as_dict(self) -> dict:
        doc = dataclasses.asdict(self)
        doc["buckets"] = list(self.buckets)
        doc["baseline_buckets"] = list(self.baseline_buckets)
        doc["format"] = PLAN_FORMAT
        return doc

    @staticmethod
    def from_dict(doc: dict) -> "GridPlan":
        return GridPlan(
            buckets=tuple(int(b) for b in doc["buckets"]),
            baseline_buckets=tuple(
                int(b) for b in doc.get("baseline_buckets", ())
            ),
            predicted_rows_per_s=float(doc["predicted_rows_per_s"]),
            baseline_rows_per_s=float(doc["baseline_rows_per_s"]),
            predicted_gain_pct=float(doc["predicted_gain_pct"]),
            predicted_waste_pct=float(doc["predicted_waste_pct"]),
            baseline_waste_pct=float(doc["baseline_waste_pct"]),
            demand_dispatches=float(doc.get("demand_dispatches", 0.0)),
            cost_model=dict(doc.get("cost_model", {})),
        )


def score_grid(
    buckets: tuple[int, ...],
    demand: list[tuple[int, float]],
    model: CostModel,
) -> tuple[float, float]:
    """Predicted ``(useful_rows_per_s, padding_waste_pct)`` of serving
    the demand through ``buckets``. Demand above the largest bucket pads
    to it (the engine's degraded/novel path would compile exactly that
    shape; the search keeps the ceiling covering observed max, so this
    only triggers on stale inputs)."""
    top = buckets[-1]
    useful = device_s = padded_total = 0.0
    for rows, weight in demand:
        padded = next((b for b in buckets if b >= rows), top)
        useful += rows * weight
        device_s += model.dispatch_s(padded) * weight
        padded_total += padded * weight
    if device_s <= 0 or padded_total <= 0:
        return 0.0, 0.0
    waste = 100.0 * (padded_total - useful) / padded_total
    return useful / device_s, waste


def _optimal_buckets(
    sizes: list[int],
    weights: list[float],
    max_entries: int,
    model: CostModel,
) -> tuple[int, ...]:
    """The DP: choose <= max_entries boundaries among sorted ``sizes``
    (the last is mandatory — it is the coverage ceiling) minimizing
    total affine cost. ``f[k][j]`` = min cost of covering sizes[0..j]
    with k chosen buckets, the k-th at sizes[j]."""
    n = len(sizes)
    k_max = min(max_entries, n)
    # prefix[j] = total weight of sizes[0..j-1]
    prefix = [0.0]
    for w in weights:
        prefix.append(prefix[-1] + w)

    def seg_cost(i: int, j: int) -> float:
        # sizes[i..j] all dispatch through a bucket at sizes[j]
        return (prefix[j + 1] - prefix[i]) * model.dispatch_s(sizes[j])

    INF = float("inf")
    # Exactly-k formulation: f[k][j] defined for j >= k-1; more buckets
    # never hurt under an affine model, but a strictly-best smaller k
    # can win when extra boundaries buy nothing — the final min over k
    # keeps the plan (and its compile bill) minimal.
    f = [[INF] * n for _ in range(k_max + 1)]
    back = [[-1] * n for _ in range(k_max + 1)]
    for j in range(n):
        f[1][j] = seg_cost(0, j)
    for k in range(2, k_max + 1):
        for j in range(k - 1, n):
            best, arg = INF, -1
            for i in range(k - 2, j):
                cand = f[k - 1][i] + seg_cost(i + 1, j)
                if cand < best:
                    best, arg = cand, i
            f[k][j] = best
            back[k][j] = arg
    # Best k ending at the mandatory ceiling sizes[n-1].
    best_k = min(range(1, k_max + 1), key=lambda k: f[k][n - 1])
    chosen = []
    j, k = n - 1, best_k
    while k > 1:
        chosen.append(sizes[j])
        j, k = back[k][j], k - 1
    chosen.append(sizes[j])
    return tuple(sorted(set(chosen)))


def search_plan(
    demand: list[tuple[int, float]],
    model: CostModel,
    current_buckets: tuple[int, ...],
    max_entries: int,
) -> GridPlan:
    """Search the grid for the given demand and return the winner as a
    plan (rejection thresholds are the CALLER's policy — controller/CLI
    apply ``min_gain_pct``; this stays a pure function of telemetry)."""
    current = tuple(sorted(current_buckets))
    ceiling = current[-1]
    sizes = sorted({min(r, ceiling) for r, _ in demand} | {ceiling})
    weights_by_size = {s: 0.0 for s in sizes}
    for rows, weight in demand:
        weights_by_size[min(rows, ceiling)] += weight
    weights = [weights_by_size[s] for s in sizes]
    best = _optimal_buckets(sizes, weights, max_entries, model)
    predicted, pred_waste = score_grid(best, demand, model)
    baseline, base_waste = score_grid(current, demand, model)
    gain = (
        100.0 * (predicted - baseline) / baseline if baseline > 0 else 0.0
    )
    return GridPlan(
        buckets=best,
        baseline_buckets=current,
        predicted_rows_per_s=predicted,
        baseline_rows_per_s=baseline,
        predicted_gain_pct=gain,
        predicted_waste_pct=pred_waste,
        baseline_waste_pct=base_waste,
        demand_dispatches=sum(w for _, w in demand),
        cost_model=model.as_dict(),
    )
