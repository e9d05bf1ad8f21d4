"""Scheme-dispatching storage: local paths and ``gs://`` URIs. A copy of
the JAX package's ``utils/storage.py``.

The deployed training Job reads its dataset and writes its registry on
GCS (``kubernetes/train-job.yml``: ``data.train_path=${DATA_URI}``,
``registry.root=${REGISTRY_ROOT}``), so ingest and the model registry
consume ``gs://`` URIs directly.

No google-cloud-storage SDK is assumed: the client speaks the GCS JSON
API over urllib with a bearer token from ``GCS_ACCESS_TOKEN`` or, failing
that, the GCE metadata server. The HTTP transport is a single injectable
function ``(method, url, data, headers) -> (status, body)``, so tests and
``chip_smoke.py`` swap in a fake bucket and never need the network.
"""

from __future__ import annotations

import json
import os
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path

from mlops_tpu_torch.utils.io import atomic_write

_API = "https://storage.googleapis.com"
_METADATA_TOKEN_URL = (
    "http://metadata.google.internal/computeMetadata/v1/"
    "instance/service-accounts/default/token"
)


def is_gcs(path: str | Path) -> bool:
    return str(path).startswith("gs://")


def split_gcs(path: str) -> tuple[str, str]:
    """``gs://bucket/a/b`` -> ``("bucket", "a/b")``."""
    rest = str(path)[len("gs://") :]
    bucket, _, key = rest.partition("/")
    if not bucket:
        raise ValueError(f"malformed gs:// path: {path!r}")
    return bucket, key


class GCSClient:
    """Minimal GCS JSON-API client. ``transport`` is
    ``(method, url, data, headers) -> (status, body_bytes)``; the default
    uses urllib, tests inject a fake."""

    def __init__(self, transport=None):
        self._transport = transport or self._urllib_transport
        self._token: str | None = None

    # ------------------------------------------------------------ transport
    @staticmethod
    def _urllib_transport(
        method: str, url: str, data: bytes | None, headers: dict[str, str]
    ) -> tuple[int, bytes]:
        req = urllib.request.Request(url, data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as err:
            return err.code, err.read()

    def _auth_headers(self) -> dict[str, str]:
        if self._token is None:
            token = os.environ.get("GCS_ACCESS_TOKEN")
            if not token:
                status, body = self._transport(
                    "GET",
                    _METADATA_TOKEN_URL,
                    None,
                    {"Metadata-Flavor": "Google"},
                )
                if status != 200:
                    raise RuntimeError(
                        "no GCS credentials: set GCS_ACCESS_TOKEN or run "
                        f"on GCE (metadata server returned {status})"
                    )
                token = json.loads(body)["access_token"]
            self._token = token
        return {"Authorization": f"Bearer {self._token}"}

    def _call(
        self, method: str, url: str, data: bytes | None = None
    ) -> tuple[int, bytes]:
        status, body = self._transport(method, url, data, self._auth_headers())
        if status == 401:
            # Metadata-server tokens expire (~1h); drop the cached one and
            # retry once with a fresh token so long-lived processes
            # (serving replicas, >1h training jobs) survive expiry.
            self._token = None
            status, body = self._transport(
                method, url, data, self._auth_headers()
            )
        return status, body

    # ------------------------------------------------------------- object ops
    def read_bytes(self, path: str) -> bytes:
        bucket, key = split_gcs(path)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
            f"/o/{urllib.parse.quote(key, safe='')}?alt=media"
        )
        status, body = self._call("GET", url)
        if status == 404:
            raise FileNotFoundError(path)
        if status != 200:
            raise RuntimeError(f"GCS read {path} failed: HTTP {status}")
        return body

    def read_to_file(self, path: str, local: "str | Path") -> None:
        """Stream an object to a local file without buffering it whole in
        memory (curated datasets can be multi-GB; ``read_bytes`` + a
        decoded copy would hold 2x the file in RAM). Streams through
        urllib when running on the real transport; injected (test)
        transports fall back to a buffered copy."""
        if self._transport is not self._urllib_transport:
            atomic_write(local, self.read_bytes(path))
            return
        bucket, key = split_gcs(path)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
            f"/o/{urllib.parse.quote(key, safe='')}?alt=media"
        )
        local = Path(local)
        local.parent.mkdir(parents=True, exist_ok=True)
        for attempt in (0, 1):
            req = urllib.request.Request(url, headers=self._auth_headers())
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    # mkstemp: concurrent fetchers of the same object each
                    # stream into their OWN temp file (a shared fixed name
                    # would interleave chunks), and the rename is atomic.
                    fd, tmp = tempfile.mkstemp(
                        dir=local.parent, prefix=f".{local.name}."
                    )
                    try:
                        with os.fdopen(fd, "wb") as f:
                            while chunk := resp.read(1 << 20):
                                f.write(chunk)
                        os.replace(tmp, local)
                    except BaseException:
                        try:
                            os.unlink(tmp)
                        except FileNotFoundError:
                            pass
                        raise
                return
            except urllib.error.HTTPError as err:
                if err.code == 401 and attempt == 0:
                    # Same expired-token recovery as _call: drop the
                    # cached token and retry once.
                    self._token = None
                    continue
                if err.code == 404:
                    raise FileNotFoundError(path) from None
                raise RuntimeError(
                    f"GCS read {path} failed: HTTP {err.code}"
                ) from None

    def write_bytes(self, path: str, data: bytes) -> None:
        bucket, key = split_gcs(path)
        url = (
            f"{_API}/upload/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
            f"/o?uploadType=media&name={urllib.parse.quote(key, safe='')}"
        )
        status, body = self._call("POST", url, data)
        if status not in (200, 201):
            raise RuntimeError(f"GCS write {path} failed: HTTP {status}")

    def stat(self, path: str) -> dict:
        """Object metadata (name/size/generation/md5Hash as available)."""
        bucket, key = split_gcs(path)
        url = (
            f"{_API}/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
            f"/o/{urllib.parse.quote(key, safe='')}"
        )
        status, body = self._call("GET", url)
        if status == 404:
            raise FileNotFoundError(path)
        if status != 200:
            raise RuntimeError(f"GCS stat {path} failed: HTTP {status}")
        return json.loads(body)

    def exists(self, path: str) -> bool:
        try:
            self.stat(path)
            return True
        except FileNotFoundError:
            return False

    def list_keys(self, path: str) -> list[str]:
        """All object keys under the ``gs://bucket/prefix`` (recursive)."""
        keys, _ = self._list(path, delimiter=None)
        return keys

    def list_prefixes(self, path: str) -> list[str]:
        """Immediate child "directories" of the prefix (``delimiter=/``
        listing) — one small page instead of every object key, e.g. the
        registry's version-number scan."""
        _, prefixes = self._list(path, delimiter="/")
        return prefixes

    def _list(
        self, path: str, delimiter: str | None
    ) -> tuple[list[str], list[str]]:
        bucket, prefix = split_gcs(path)
        keys: list[str] = []
        prefixes: list[str] = []
        page = ""
        while True:
            url = (
                f"{_API}/storage/v1/b/{urllib.parse.quote(bucket, safe='')}"
                f"/o?prefix={urllib.parse.quote(prefix, safe='')}"
                f"&fields=items(name),prefixes,nextPageToken"
            )
            if delimiter:
                url += f"&delimiter={urllib.parse.quote(delimiter, safe='')}"
            if page:
                url += f"&pageToken={urllib.parse.quote(page, safe='')}"
            status, body = self._call("GET", url)
            if status != 200:
                raise RuntimeError(f"GCS list {path} failed: HTTP {status}")
            payload = json.loads(body or b"{}")
            keys.extend(item["name"] for item in payload.get("items", []))
            prefixes.extend(payload.get("prefixes", []))
            page = payload.get("nextPageToken", "")
            if not page:
                return keys, prefixes


_default_client: GCSClient | None = None


def gcs_client() -> GCSClient:
    """Process-wide client (token cached). Tests construct their own."""
    global _default_client
    if _default_client is None:
        _default_client = GCSClient()
    return _default_client


# ---------------------------------------------------------------- facade
def read_bytes(path: str | Path, client: GCSClient | None = None) -> bytes:
    if is_gcs(path):
        return (client or gcs_client()).read_bytes(str(path))
    return Path(path).read_bytes()


def write_bytes(
    path: str | Path, data: bytes, client: GCSClient | None = None
) -> None:
    if is_gcs(path):
        (client or gcs_client()).write_bytes(str(path), data)
        return
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    atomic_write(path, data)


def exists(path: str | Path, client: GCSClient | None = None) -> bool:
    if is_gcs(path):
        return (client or gcs_client()).exists(str(path))
    return Path(path).exists()


def join(base: str | Path, *parts: str) -> str | Path:
    if is_gcs(base):
        return "/".join([str(base).rstrip("/"), *parts])
    return Path(base).joinpath(*parts)


def upload_dir(
    local_dir: str | Path, dest: str, client: GCSClient | None = None
) -> None:
    """Recursively copy a local directory to ``gs://bucket/prefix``."""
    client = client or gcs_client()
    local_dir = Path(local_dir)
    for file in sorted(p for p in local_dir.rglob("*") if p.is_file()):
        rel = file.relative_to(local_dir).as_posix()
        client.write_bytes(f"{dest.rstrip('/')}/{rel}", file.read_bytes())


def download_dir(
    src: str, local_dir: str | Path, client: GCSClient | None = None
) -> Path:
    """Recursively copy ``gs://bucket/prefix`` into a local directory.

    The prefix is listed with a terminating ``/`` — a bare ``.../1``
    prefix would also match sibling keys ``.../10/...``, ``.../11/...``
    (registry version 1 pulling versions 10-19 into its cache).
    """
    client = client or gcs_client()
    local_dir = Path(local_dir)
    src = src.rstrip("/")
    bucket, prefix = split_gcs(src + "/")
    keys = client.list_keys(src + "/")
    if not keys:
        raise FileNotFoundError(src)
    for key in keys:
        rel = key[len(prefix) :].lstrip("/")
        target = local_dir / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        atomic_write(target, client.read_bytes(f"gs://{bucket}/{key}"))
    return local_dir
