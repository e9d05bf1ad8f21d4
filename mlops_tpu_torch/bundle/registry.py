"""Filesystem model registry: a copy of the JAX package's
``ModelRegistry.register`` and its ``index.json`` layout for local roots,
so a bundle the port registers resolves through the JAX package's
registry (and the other way round).

Layout::

    <root>/<name>/versions/<v>/   the bundle directory
    <root>/<name>/index.json      versions, stages, tags (atomic rewrite)

A ``gs://`` root is not ported and is refused."""

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

# Intra-process serialization of index mutations, keyed by resolved
# (root, name); the cross-process half is an flock beside the index.
_LOCKS_GUARD = threading.Lock()
_LOCKS: dict[str, threading.Lock] = {}


class ModelRegistry:
    """Registry over a local directory."""

    def __init__(self, root: str | Path) -> None:
        if str(root).startswith("gs://"):
            raise ValueError(
                f"registry root {root!r}: gs:// registries are not ported "
                "(ROADMAP.md, queue C); use a local directory"
            )
        self.root = Path(root)

    @contextlib.contextmanager
    def _locked(self, name: str) -> Iterator[None]:
        """A process-local lock for threads plus an ``flock`` (under
        ``<root>/.locks``) for concurrent processes."""
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
                "created_at": datetime.datetime.now(datetime.timezone.utc).isoformat(),
                "stage": "none",
                "tags": tags or {},
            })
            atomic_write(self._index_path(name), json.dumps(index, indent=2).encode())
            return f"models:/{name}/{version}"
