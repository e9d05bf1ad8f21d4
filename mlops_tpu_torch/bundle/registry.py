"""Model registry with staged promotion: a copy of the JAX package's
``ModelRegistry`` (``mlops_tpu/bundle/registry.py``) and its
``index.json`` layout, over a local directory or a ``gs://bucket/prefix``
root, so a registry either package writes is read and promoted by the
other (and, on a local root, pruned).

Layout::

    <root>/<name>/versions/<v>/   the bundle directory
    <root>/<name>/index.json      versions, stages, tags (atomic rewrite)

Versions are addressed as ``models:/<name>/<version-or-stage>``; a
version number, a stage of ``STAGES`` or ``latest`` resolves to its
bundle directory. On GCS a resolved version is downloaded into a local
cache (``~/.cache/mlops_tpu/registry/<sha256(root)[:16]>/<name>/<v>``,
the JAX package's: bundle versions are immutable), through a temporary
sibling and a rename, so a reader of either package never sees half a
bundle. GCS has no lock: the GCS flavor keeps the JAX package's
single-writer contract (one release pipeline registers and promotes at a
time), and ``gc`` refuses a ``gs://`` root as the JAX package's does."""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import hashlib
import json
import shutil
import threading
import uuid
from pathlib import Path
from typing import Any, Iterator

from mlops_tpu_torch.utils import storage

STAGES = ("none", "staging", "production")

# Intra-process serialization of index mutations, keyed by resolved
# (root, name); the cross-process half is an flock beside the index.
_LOCKS_GUARD = threading.Lock()
_LOCKS: dict[str, threading.Lock] = {}


def parse_model_uri(uri: str) -> tuple[str, str]:
    """Parse ``models:/<name>/<version-or-stage>``."""
    if not uri.startswith("models:/"):
        raise ValueError(f"not a model uri: {uri!r}")
    name, _, version = uri[len("models:/"):].partition("/")
    if not name or not version:
        raise ValueError(f"malformed model uri: {uri!r}")
    return name, version


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()


class ModelRegistry:
    """Registry over a local directory or a ``gs://bucket/prefix`` root
    (``client``: the GCS client, the process-wide one when None;
    ``cache_dir``: where GCS versions download, the per-user cache when
    None)."""

    def __init__(
        self,
        root: str | Path,
        client: storage.GCSClient | None = None,
        cache_dir: str | Path | None = None,
    ) -> None:
        self._gcs = storage.is_gcs(root)
        self.root = str(root).rstrip("/") if self._gcs else Path(root)
        self._client = client
        # Per user, created 0700 in resolve(): a shared temp dir would let
        # another local user plant a "cached" bundle that resolve() trusts
        # as immutable. Namespaced by the root, so two registries never
        # serve each other's versions.
        root_tag = hashlib.sha256(str(self.root).encode()).hexdigest()[:16]
        self._cache_dir = (
            Path(cache_dir or Path.home() / ".cache" / "mlops_tpu" / "registry")
            / root_tag
        )

    @contextlib.contextmanager
    def _locked(self, name: str) -> Iterator[None]:
        """A process-local lock for threads plus an ``flock`` (under
        ``<root>/.locks``, the JAX package's lock file) for concurrent
        processes of either package. A GCS root takes no lock: object
        stores have none, and the release pipeline is the one writer."""
        if self._gcs:
            yield
            return
        key = str(self.root.resolve() / name)
        with _LOCKS_GUARD:
            thread_lock = _LOCKS.setdefault(key, threading.Lock())
        with thread_lock:
            lock_dir = self.root / ".locks"
            lock_dir.mkdir(parents=True, exist_ok=True)
            with open(lock_dir / f"{name}.lock", "w") as lock_file:
                fcntl.flock(lock_file, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lock_file, fcntl.LOCK_UN)

    def _index_path(self, name: str) -> str | Path:
        return storage.join(self.root, name, "index.json")

    def _read_index(self, name: str) -> dict[str, Any]:
        try:
            return json.loads(storage.read_bytes(self._index_path(name), self._client))
        except FileNotFoundError:
            return {"name": name, "versions": []}

    def _write_index(self, name: str, index: dict[str, Any]) -> None:
        storage.write_bytes(
            self._index_path(name), json.dumps(index, indent=2).encode(), self._client
        )

    def _stored_versions(self, name: str) -> list[int]:
        """Version numbers physically present under versions/ (the orphan
        scan). On GCS a listing failure fails the register: numbering
        from the index alone could merge a new bundle into a crashed
        upload's orphan."""
        if self._gcs:
            client = self._client or storage.gcs_client()
            found = set()
            for child in client.list_prefixes(f"{self.root}/{name}/versions/"):
                head = child.rstrip("/").rsplit("/", 1)[-1]
                if head.isdigit():
                    found.add(int(head))
            return sorted(found)
        versions_dir = self.root / name / "versions"
        return sorted(
            int(p.name)
            for p in versions_dir.glob("[0-9]*")
            if p.is_dir() and p.name.isdigit()
        )

    def register(
        self, name: str, bundle_dir: str | Path, tags: dict[str, str] | None = None
    ) -> str:
        """Copy a bundle into the registry as the next version; returns
        ``models:/<name>/<version>``."""
        with self._locked(name):
            index = self._read_index(name)
            # Next version = 1 + max over the index AND the stored dirs, so
            # an orphan of a crash between copy and index write never
            # collides with a later registration.
            version = 1 + max(
                [0, *(v["version"] for v in index["versions"]),
                 *self._stored_versions(name)]
            )
            if self._gcs:
                # GCS has no rename: objects upload under the final
                # prefix, the version becomes resolvable when the index
                # write lands, and a crashed upload is an orphan the scan
                # above numbers past.
                storage.upload_dir(
                    bundle_dir, f"{self.root}/{name}/versions/{version}", self._client
                )
            else:
                versions_dir = self.root / name / "versions"
                versions_dir.mkdir(parents=True, exist_ok=True)
                staging = versions_dir / f".incoming-{uuid.uuid4().hex}"
                try:
                    shutil.copytree(bundle_dir, staging)
                    staging.replace(versions_dir / str(version))
                except BaseException:
                    shutil.rmtree(staging, ignore_errors=True)
                    raise
            index["versions"].append({
                "version": version,
                "created_at": _now(),
                "stage": "none",
                "tags": tags or {},
            })
            self._write_index(name, index)
            return f"models:/{name}/{version}"

    def resolve(self, name: str, version_or_stage: str) -> Path:
        """A version number, a stage name or ``latest`` -> its bundle
        directory (a stage: the newest version holding it; on GCS, the
        version's copy in the local cache)."""
        index = self._read_index(name)
        if not index["versions"]:
            raise KeyError(f"no versions registered for model {name!r}")
        if version_or_stage == "latest":
            version = max(v["version"] for v in index["versions"])
        elif version_or_stage.isdigit():
            version = int(version_or_stage)
            if not any(v["version"] == version for v in index["versions"]):
                raise KeyError(f"model {name!r} has no version {version}")
        elif version_or_stage in STAGES:
            staged = [v for v in index["versions"] if v["stage"] == version_or_stage]
            if not staged:
                raise KeyError(
                    f"model {name!r} has no version in stage {version_or_stage!r}"
                )
            version = max(v["version"] for v in staged)
        else:
            raise KeyError(f"unknown version or stage {version_or_stage!r}")
        if not self._gcs:
            return self.root / name / "versions" / str(version)
        # Versions are immutable, so a cached copy is authoritative; the
        # download lands in a temporary sibling and is renamed into place.
        local = self._cache_dir / name / str(version)
        if not local.exists():
            self._cache_dir.mkdir(parents=True, exist_ok=True, mode=0o700)
            local.parent.mkdir(parents=True, exist_ok=True)
            incoming = local.parent / f".incoming-{uuid.uuid4().hex}"
            try:
                storage.download_dir(
                    f"{self.root}/{name}/versions/{version}", incoming, self._client
                )
                try:
                    incoming.replace(local)
                except OSError:
                    # A concurrent resolver won the rename; its copy of the
                    # immutable bundle is as good as ours.
                    if not (local / "manifest.json").exists():
                        raise
                    shutil.rmtree(incoming, ignore_errors=True)
            except BaseException:
                shutil.rmtree(incoming, ignore_errors=True)
                raise
        return local

    def resolve_uri(self, uri: str) -> Path:
        return self.resolve(*parse_model_uri(uri))

    def set_stage(self, name: str, version: int, stage: str) -> None:
        """Promote or demote a version. Single holder: promoting a version
        to a stage archives (stage ``none``) whichever version held it;
        the version's ``<stage>_since`` is stamped."""
        if stage not in STAGES:
            raise ValueError(f"stage must be one of {STAGES}")
        with self._locked(name):
            index = self._read_index(name)
            target = next(
                (e for e in index["versions"] if e["version"] == version), None
            )
            if target is None:
                raise KeyError(f"model {name!r} has no version {version}")
            if stage != "none":
                for entry in index["versions"]:
                    if entry is not target and entry["stage"] == stage:
                        entry["stage"] = "none"
            target["stage"] = stage
            target[f"{stage}_since"] = _now()
            self._write_index(name, index)

    def list_versions(self, name: str) -> list[dict[str, Any]]:
        return self._read_index(name)["versions"]

    def gc(self, name: str, keep_unstaged: int = 0) -> dict[str, list[int]]:
        """Prune one model's registry garbage: orphan version dirs (on
        disk, absent from the index) and abandoned ``.incoming-*`` copies,
        the leftovers of a crash mid-register; with ``keep_unstaged > 0``
        also the oldest stage-``none`` versions beyond the newest N.
        Staged versions are never touched. Returns what was removed. A
        ``gs://`` root is refused, as in the JAX package: with no lock, a
        pruning pass could delete a registration in flight."""
        if self._gcs:
            raise ValueError(
                "gc supports the local registry backend; for gs:// roots "
                "use bucket lifecycle rules (versions are immutable "
                "prefixes)"
            )
        with self._locked(name):
            index = self._read_index(name)
            known = {v["version"] for v in index["versions"]}
            versions_dir = self.root / name / "versions"
            orphans_removed = []
            for v in self._stored_versions(name):
                if v not in known:
                    shutil.rmtree(versions_dir / str(v), ignore_errors=True)
                    orphans_removed.append(v)
            # No register can be in flight while gc holds the lock, so
            # staging dirs left by a killed register are safe to drop.
            if versions_dir.is_dir():
                for staging in versions_dir.glob(".incoming-*"):
                    shutil.rmtree(staging, ignore_errors=True)
            versions_removed = []
            if keep_unstaged > 0:
                unstaged = sorted(
                    (e for e in index["versions"] if e["stage"] == "none"),
                    key=lambda e: e["version"],
                )
                doomed = unstaged[:-keep_unstaged]
                if doomed:
                    # Index first, dirs after: a crash mid-loop leaves only
                    # orphan dirs, which the scan above heals next time.
                    for entry in doomed:
                        index["versions"].remove(entry)
                        versions_removed.append(entry["version"])
                    self._write_index(name, index)
                    for v in versions_removed:
                        shutil.rmtree(versions_dir / str(v), ignore_errors=True)
            return {
                "orphans_removed": orphans_removed,
                "versions_removed": versions_removed,
            }


def resolve_bundle(config, model_dir: str | None = None) -> str | Path:
    """One rule for every command: a value that is an existing directory
    is the bundle itself; anything else (a version number, a stage,
    ``latest``) resolves through the registry at ``registry.root``."""
    model_dir = model_dir or config.serve.model_directory
    if Path(model_dir).is_dir():
        return model_dir
    return ModelRegistry(config.registry.root).resolve(config.registry.model_name, model_dir)
