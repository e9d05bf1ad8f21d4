"""Tenant routing: the ``x-tenant`` header to a tenant index, bounded.

A copy of the JAX package's ``tenancy/router.py``. Torch-free (the HTTP
front ends import it); immutable after construction, so it is shared
across threads and inherited across forks without a lock.
"""

from __future__ import annotations

from mlops_tpu_torch.tenancy.config import DEFAULT_TENANT, TenancyConfig

# The label of a request naming an unknown tenant (it answers 404):
# arbitrary header text never becomes a label value.
UNKNOWN_TENANT_LABEL = "<unknown>"


class TenantRouter:
    """Name <-> index resolution for one plane's tenant fleet."""

    __slots__ = ("names", "default_index", "_index")

    def __init__(self, names: tuple[str, ...], default_index: int = 0) -> None:
        if not names:
            names = (DEFAULT_TENANT,)
        self.names = tuple(names)
        self.default_index = int(default_index)
        self._index = {name: i for i, name in enumerate(self.names)}

    @classmethod
    def from_config(cls, tenancy: TenancyConfig) -> "TenantRouter":
        return cls(tenancy.names, tenancy.default_index)

    def resolve(self, raw: str) -> int | None:
        """The tenant index of an ``x-tenant`` value: an empty or absent
        header rides the default tenant; an unknown name gives None (the
        caller answers 404 rather than bill the default tenant's quota and
        monitors for a stranger's traffic)."""
        if not raw:
            return self.default_index
        return self._index.get(raw)

    def label(self, raw: str) -> str:
        """The bounded label of a header value: the tenant's name (the
        default's for untagged traffic) or the unknown marker."""
        if not raw:
            return self.names[self.default_index]
        if raw in self._index:
            return raw
        return UNKNOWN_TENANT_LABEL

    def bill_label(self, raw: str) -> str:
        """The tenant whose metrics row a request lands on: always a
        declared name. Strangers' 404s bill the default tenant, as the
        ring's shared-memory counters have one row per declared tenant and
        both planes emit the same series."""
        if raw in self._index:
            return raw
        return self.names[self.default_index]
