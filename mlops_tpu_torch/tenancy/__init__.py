"""Multi-tenant serving: one plane, many portfolios.

The port of the JAX package's ``tenancy/``: N named tenants served from
one engine process, each with its own engine (its bundle, monitor
accumulator, CUDA graphs and lifecycle state), routed by the ``x-tenant``
header, admitted on the ring plane through weighted max-min quotas, and
labelled ``tenant`` on every per-tenant series.

``config``, ``quota`` and ``router`` import no torch (the front-end
processes import them); ``registry`` builds engines and is imported
lazily, so ``from mlops_tpu_torch.tenancy import TenantRouter`` stays
torch-free.
"""

from mlops_tpu_torch.tenancy.config import (  # noqa: F401
    DEFAULT_TENANT,
    TenancyConfig,
    TenancyConfigError,
    TenantSpec,
    load_tenants_toml,
    single_tenant_config,
)
from mlops_tpu_torch.tenancy.quota import QuotaGovernor  # noqa: F401
from mlops_tpu_torch.tenancy.router import (  # noqa: F401
    UNKNOWN_TENANT_LABEL,
    TenantRouter,
)

_LAZY = {"TenantRegistry", "tenant_scoped_config"}


def __getattr__(name: str):
    if name in _LAZY:
        from mlops_tpu_torch.tenancy import registry

        return getattr(registry, name)
    raise AttributeError(name)
