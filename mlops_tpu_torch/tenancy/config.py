"""The tenants.toml contract: a serving plane's tenant fleet, torch-free.

A copy of the JAX package's ``tenancy/config.py``. ``serve --tenants
tenants.toml`` declares the fleet in one TOML file: tenant names, bundle
directories, quota weights, and the default tenant untagged traffic
lands on::

    default_tenant = "emea"

    [[tenant]]
    name = "emea"
    bundle_dir = "registry/credit-default/3"
    weight = 2.0

    [[tenant]]
    name = "apac"
    bundle_dir = "registry/credit-default-apac/1"
    # weight defaults to 1.0

The front-end processes and the CLI's config layer read it, so nothing
here imports torch.
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path

DEFAULT_TENANT = "default"

# Tenant names become Prometheus label values: the request ids' bounded
# charset keeps label-injection text out of the exposition.
_NAME_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-"
)


class TenancyConfigError(ValueError):
    """An inconsistent tenant fleet, named at startup: duplicate names,
    weights not above zero and missing bundle directories fail the
    rollout with the constraint spelled out."""


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a name (the ``x-tenant`` header and the ``tenant``
    label of every per-tenant series), the bundle it serves, and its
    weight in the weighted max-min quota."""

    name: str
    bundle_dir: str
    weight: float = 1.0


@dataclasses.dataclass
class TenancyConfig:
    """The fleet: an ordered tuple of tenants (a tenant's index, the ring
    slot's tag and its stats row, is its position here, so the order is
    part of the serving contract for a plane's lifetime) and the default
    tenant untagged requests resolve to."""

    tenants: tuple[TenantSpec, ...] = ()
    default_tenant: str = ""  # empty: the first tenant

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(spec.name for spec in self.tenants)

    @property
    def weights(self) -> tuple[float, ...]:
        return tuple(float(spec.weight) for spec in self.tenants)

    @property
    def default_index(self) -> int:
        if not self.default_tenant:
            return 0
        return self.names.index(self.default_tenant)

    def validate(self, check_bundles: bool = True) -> "TenancyConfig":
        """Refuse a broken fleet with every problem named.
        ``check_bundles=False`` skips the bundle directories' existence."""
        problems: list[str] = []
        if not self.tenants:
            problems.append("tenancy: at least one [[tenant]] is required")
        seen: set[str] = set()
        for spec in self.tenants:
            if not spec.name:
                problems.append("tenancy: tenant name must be non-empty")
                continue
            if len(spec.name) > 64 or not set(spec.name) <= _NAME_CHARS:
                problems.append(
                    f"tenancy: tenant name {spec.name!r} must be 1-64 chars "
                    "of [A-Za-z0-9_-] (it becomes a Prometheus label value "
                    "and a span field)"
                )
            if spec.name in seen:
                problems.append(f"tenancy: duplicate tenant name {spec.name!r}")
            seen.add(spec.name)
            if not spec.weight > 0:
                problems.append(
                    f"tenancy: tenant {spec.name!r} weight={spec.weight} "
                    "must be > 0 (a zero-weight tenant could never admit a "
                    "request; remove it instead)"
                )
            if not spec.bundle_dir:
                problems.append(f"tenancy: tenant {spec.name!r} has no bundle_dir")
            elif check_bundles and not Path(spec.bundle_dir).is_dir():
                problems.append(
                    f"tenancy: tenant {spec.name!r} bundle_dir="
                    f"{spec.bundle_dir!r} is not a directory"
                )
        if self.default_tenant and self.default_tenant not in seen:
            problems.append(
                f"tenancy: default_tenant={self.default_tenant!r} names no "
                "declared tenant"
            )
        if problems:
            raise TenancyConfigError("; ".join(problems))
        return self


def single_tenant_config(bundle_dir: str) -> TenancyConfig:
    """The fleet of a plane without a tenants file: one tenant named
    ``default`` serving the configured bundle."""
    return TenancyConfig(
        tenants=(TenantSpec(name=DEFAULT_TENANT, bundle_dir=bundle_dir),),
        default_tenant=DEFAULT_TENANT,
    )


def load_tenants_toml(path: str | Path) -> TenancyConfig:
    """Parse a tenants.toml. Shape errors raise ``TenancyConfigError``
    naming the key; validation is the caller's next step."""
    path = Path(path)
    try:
        with open(path, "rb") as f:
            doc = tomllib.load(f)
    except OSError as err:
        raise TenancyConfigError(f"tenancy: cannot read {path}: {err}")
    except tomllib.TOMLDecodeError as err:
        raise TenancyConfigError(f"tenancy: {path} is not valid TOML: {err}")
    # Unknown keys are named at both levels: a misspelled default_tenant
    # would otherwise fall back to the first tenant and route untagged
    # traffic to the wrong model.
    unknown_top = set(doc) - {"tenant", "default_tenant"}
    if unknown_top:
        raise TenancyConfigError(
            f"tenancy: {path} has unknown top-level keys "
            f"{sorted(unknown_top)} (expected 'default_tenant' and "
            "[[tenant]] tables)"
        )
    raw_tenants = doc.get("tenant", [])
    if not isinstance(raw_tenants, list):
        raise TenancyConfigError(
            f"tenancy: {path} 'tenant' must be an array of tables "
            "([[tenant]] blocks)"
        )
    specs: list[TenantSpec] = []
    for i, entry in enumerate(raw_tenants):
        if not isinstance(entry, dict):
            raise TenancyConfigError(f"tenancy: {path} [[tenant]] #{i} is not a table")
        unknown = set(entry) - {"name", "bundle_dir", "weight"}
        if unknown:
            raise TenancyConfigError(
                f"tenancy: {path} [[tenant]] #{i} has unknown keys "
                f"{sorted(unknown)}"
            )
        try:
            specs.append(
                TenantSpec(
                    name=str(entry.get("name", "")),
                    bundle_dir=str(entry.get("bundle_dir", "")),
                    weight=float(entry.get("weight", 1.0)),
                )
            )
        except (TypeError, ValueError) as err:
            raise TenancyConfigError(f"tenancy: {path} [[tenant]] #{i}: {err}")
    return TenancyConfig(
        tenants=tuple(specs),
        default_tenant=str(doc.get("default_tenant", "")),
    )
