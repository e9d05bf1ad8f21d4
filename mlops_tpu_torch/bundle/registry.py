"""Filesystem model registry with staged promotion: a copy of the JAX
package's ``ModelRegistry`` (``mlops_tpu/bundle/registry.py``) and its
``index.json`` layout for local roots, so a registry either package
writes is read, promoted and pruned by the other.

Layout::

    <root>/<name>/versions/<v>/   the bundle directory
    <root>/<name>/index.json      versions, stages, tags (atomic rewrite)

Versions are addressed as ``models:/<name>/<version-or-stage>``; a
version number, a stage of ``STAGES`` or ``latest`` resolves to its
bundle directory. A ``gs://`` root is not ported (ROADMAP A6) and is
refused."""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import json
import shutil
import threading
import uuid
from pathlib import Path
from typing import Any, Iterator

from mlops_tpu_torch.utils.io import atomic_write

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
    """Registry over a local directory."""

    def __init__(self, root: str | Path) -> None:
        if str(root).startswith("gs://"):
            raise ValueError(
                f"registry root {root!r}: gs:// registries are not ported "
                "(ROADMAP.md A6); use a local directory"
            )
        self.root = Path(root)

    @contextlib.contextmanager
    def _locked(self, name: str) -> Iterator[None]:
        """A process-local lock for threads plus an ``flock`` (under
        ``<root>/.locks``, the JAX package's lock file) for concurrent
        processes of either package."""
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

    def _index_path(self, name: str) -> Path:
        return self.root / name / "index.json"

    def _read_index(self, name: str) -> dict[str, Any]:
        try:
            return json.loads(self._index_path(name).read_bytes())
        except FileNotFoundError:
            return {"name": name, "versions": []}

    def _write_index(self, name: str, index: dict[str, Any]) -> None:
        atomic_write(self._index_path(name), json.dumps(index, indent=2).encode())

    def _stored_versions(self, name: str) -> list[int]:
        """Version numbers physically present under versions/."""
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
        directory (a stage: the newest version holding it)."""
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
        return self.root / name / "versions" / str(version)

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
        Staged versions are never touched. Returns what was removed."""
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
