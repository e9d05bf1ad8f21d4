"""The tenant bundle registry: N bundles -> N engines, each warmed.

The port of the JAX package's ``tenancy/registry.py``. Every tenant gets
its own ``InferenceEngine``: its own parameters, monitor accumulator,
temperature, lifecycle tee, held streams and CUDA graphs. The JAX
package's architecture twins share compiled executables, because its
programs take the parameters as arguments; a CUDA graph bakes in its own
engine's parameter and accumulator addresses, so here every tenant
captures its own graphs (about 255 MiB of graph pool per exact tenant)
and what twins share is the process's kernel libraries, built or loaded
once. The warmup report keeps the JAX keys and says so:
``shared_exec_count`` is 0, and a twin names the tenant whose
architecture it has.

The tenant list is fixed at construction and ``warmup`` runs once, before
traffic, on the starting thread: no locks here; serving-time
synchronization lives in the engines.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Callable

from mlops_tpu_torch.config import Config
from mlops_tpu_torch.tenancy.config import TenancyConfig

logger = logging.getLogger("mlops_tpu_torch.tenancy")


def _arch_key(engine: Any) -> str:
    """What would let twins share programs in the JAX package: the model
    config and the shapes of every tier's parameters (an engine without a
    bundle is its own architecture)."""
    bundle = getattr(engine, "bundle", None)
    if bundle is None:
        return str(id(engine))
    shapes = {
        tier: sorted((k, list(v.shape), str(v.dtype)) for k, v in t.params.items())
        for tier, t in engine._tiers.items()
    }
    config = dataclasses.asdict(bundle.model_config) if bundle.model is not None else {}
    return json.dumps({"model_config": config, "params": shapes}, sort_keys=True)


class TenantRegistry:
    """Load every tenant's bundle, build one engine per tenant with the
    fleet-wide ``serve_tier`` and ``tier_routing``, and warm them. A
    tenant's index is its position in ``tenancy.tenants``: the index the
    ring slot's tag, the quota governor and the per-tenant rows use."""

    def __init__(
        self,
        tenancy: TenancyConfig,
        buckets: tuple[int, ...] = (1, 8, 64, 256),
        serve_tier: str = "exact",
        device: str = "cuda",
        tier_routing: bool = False,
        make_engine: Callable[[str], Any] | None = None,
        mesh: Any = None,
    ) -> None:
        """``make_engine(bundle_dir)``, when given, builds each tenant's
        engine instead (the ring plane's replica processes pass theirs).
        ``mesh`` (``serve.model_shards``, fleet-wide as in the JAX
        package) lays every tenant's params out over the same
        ('model',) mesh."""
        self.tenancy = tenancy.validate()
        self.names: tuple[str, ...] = self.tenancy.names
        self.default_index = self.tenancy.default_index
        if make_engine is None:
            from mlops_tpu_torch.bundle import load_bundle
            from mlops_tpu_torch.serve.engine import InferenceEngine

            # serve_tier and tier_routing are fleet-wide, as in the JAX
            # package; each engine resolves its own tiers from its bundle
            # (a tenant without a gated quant student serves exact only).
            def make_engine(bundle_dir: str) -> Any:
                return InferenceEngine(load_bundle(bundle_dir), buckets=buckets,
                                       serve_tier=serve_tier, device=device,
                                       tier_routing=tier_routing, mesh=mesh)
        self.engines = [make_engine(spec.bundle_dir) for spec in self.tenancy.tenants]
        # Tenants served through another tenant's programs: none here (a
        # CUDA graph holds its own engine's addresses).
        self.shared_exec_count = 0

    def __len__(self) -> int:
        return len(self.engines)

    @property
    def default_engine(self) -> Any:
        return self.engines[self.default_index]

    @property
    def ready(self) -> bool:
        return all(engine.ready for engine in self.engines)

    def index(self, name: str) -> int:
        return self.names.index(name)

    def warmup(self) -> dict[str, Any]:
        """Warm every tenant's engine (each captures its own graphs);
        the per-tenant report of the JAX package, a twin naming the tenant
        it shares kernel libraries with."""
        donors: dict[str, str] = {}
        report: dict[str, Any] = {}
        for name, engine in zip(self.names, self.engines):
            engine.warmup()
            report[name] = {"mode": "warmed", **getattr(engine, "warmup_stats", {})}
            if not getattr(engine, "monitor_accumulating", True):
                continue  # the sklearn host hybrid: a host estimator, no twin
            donor = donors.setdefault(_arch_key(engine), name)
            if donor != name:
                report[name]["arch_twin_of"] = donor
                logger.info("tenant %s has %s's architecture: its kernel libraries "
                            "are shared, its graphs its own", name, donor)
        report["shared_exec_count"] = self.shared_exec_count
        return report


def tenant_scoped_config(config: Config, tenant: str) -> Config:
    """A tenant's view of the config for its lifecycle controller: the same
    knobs, with the controller's state directory namespaced per tenant
    (``lifecycle.dir/<tenant>``), so reservoirs, candidates and retrain
    checkpoints never cross tenants."""
    return dataclasses.replace(
        config,
        lifecycle=dataclasses.replace(
            config.lifecycle, dir=str(Path(config.lifecycle.dir) / tenant)
        ),
    )
