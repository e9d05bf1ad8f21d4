"""The port's ``gs://`` storage (``mlops_tpu_torch/utils/storage.py``),
staging (``data/ingest.py fetch_local``) and registry flavor against the
JAX package's, on the CPU, with no network.

Two fakes stand in for GCS: the JAX suite's in-memory ``FakeGCS``
(``tests/test_storage.py``) and ``chip_smoke.FileBucket``, the
file-backed bucket ``chip_smoke.py`` runs the deployed Job against on the
card; each client test runs on both. Both packages' clients make the same
calls against one fake, byte for byte; a registry either package writes
on a bucket is resolved and promoted by the other with equal indexes and
equal bundle bytes; ``gc`` refuses a ``gs://`` root in both with the same
message; ``tune`` from a ``gs://`` CSV into a ``gs://`` registry registers
a bundle whose params equal, bit for bit, those of the same run on local
paths."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mlops_tpu.bundle.registry import ModelRegistry as JaxRegistry
from mlops_tpu.data.ingest import fetch_local as jax_fetch_local
from mlops_tpu.data.ingest import load_csv_columns as jax_load_csv_columns
from mlops_tpu.utils import storage as jax_storage
from mlops_tpu_torch.bundle.registry import ModelRegistry
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.data import generate_synthetic, write_csv_columns
from mlops_tpu_torch.data.ingest import fetch_local, load_csv_columns
from mlops_tpu_torch.data.stream import iter_csv_chunks
from mlops_tpu_torch.utils import storage
from test_storage import FakeGCS
from torch_gcs import install_fake_bucket

NAME = "credit-default-uci-custom"
PACKAGES = {"jax": jax_storage, "port": storage}


@pytest.fixture(params=["memory", "files"])
def make_fake(request, tmp_path):
    """A factory of fresh, empty fakes of one kind."""
    count = iter(range(100))
    if request.param == "memory":
        return FakeGCS
    return lambda: chip_smoke.FileBucket(tmp_path / f"bucket{next(count)}")


def _client(module, fake):
    return module.GCSClient(transport=fake.transport)


def _calls(fake) -> list[str]:
    """What a fake was asked, in order: FakeGCS's log, or FileBucket's."""
    if isinstance(fake, FakeGCS):
        return fake.calls
    return [f"{kind} {key} {nbytes}" for kind, key, nbytes, _ in fake.calls]


def test_the_path_helpers_are_the_jax_ones():
    for path in ("gs://b/k", "/tmp/x", Path("gs-not/x")):
        assert storage.is_gcs(path) == jax_storage.is_gcs(path)
    for path in ("gs://bucket/a/b.csv", "gs://bucket", "gs://b/p/"):
        assert storage.split_gcs(path) == jax_storage.split_gcs(path)
    assert storage.join("gs://b/p/", "x", "y") == jax_storage.join("gs://b/p/", "x", "y")
    assert storage.join(Path("/r"), "x") == jax_storage.join(Path("/r"), "x")
    with pytest.raises(ValueError, match="malformed"):
        storage.split_gcs("gs:///nope")


def test_a_round_trip_makes_the_jax_calls(make_fake):
    logs = {}
    for who, module in PACKAGES.items():
        fake = make_fake()
        client = _client(module, fake)
        client.write_bytes("gs://est/data/curated.csv", b"a,b\n1,2\n")
        assert client.exists("gs://est/data/curated.csv")
        assert not client.exists("gs://est/data/other.csv")
        assert client.read_bytes("gs://est/data/curated.csv") == b"a,b\n1,2\n"
        assert client.stat("gs://est/data/curated.csv")["size"] == "8"
        with pytest.raises(FileNotFoundError):
            client.read_bytes("gs://est/data/other.csv")
        logs[who] = _calls(fake)
    assert logs["port"] == logs["jax"]
    assert "metadata.google.internal" in logs["port"][0] or logs["port"][0].startswith("token")


def test_listing_pages_as_the_jax_client(make_fake):
    got = {}
    for who, module in PACKAGES.items():
        fake = make_fake()
        client = _client(module, fake)
        for i in range(9):
            client.write_bytes(f"gs://est/reg/m/versions/{i % 3}/f{i}", b"x")
        client.write_bytes("gs://est/reg/m/index.json", b"{}")
        got[who] = (client.list_keys("gs://est/reg/m/versions/"),
                    client.list_prefixes("gs://est/reg/m/versions/"),
                    client.list_prefixes("gs://est/reg/"), _calls(fake))
    assert got["port"] == got["jax"]
    keys, versions, models, calls = got["port"]
    assert len(keys) == 9 and versions == [f"reg/m/versions/{v}/" for v in range(3)]
    assert models == ["reg/m/"]
    assert sum("pageToken" in c or c.startswith("list") for c in calls) >= 3


def test_a_directory_round_trips_and_version_1_never_pulls_version_10(make_fake, tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"A")
    (src / "sub" / "b.txt").write_bytes(b"B")
    for who, module in PACKAGES.items():
        fake = make_fake()
        client = _client(module, fake)
        module.upload_dir(src, "gs://est/reg/m/versions/1", client)
        client.write_bytes("gs://est/reg/m/versions/10/manifest.json", b"v10")
        out = module.download_dir("gs://est/reg/m/versions/1", tmp_path / who, client)
        assert sorted(p.relative_to(out).as_posix() for p in out.rglob("*") if p.is_file()) \
            == ["a.txt", "sub/b.txt"]
        assert (out / "sub" / "b.txt").read_bytes() == b"B"
        with pytest.raises(FileNotFoundError):
            module.download_dir("gs://est/reg/m/versions/3", tmp_path / f"{who}3", client)


def test_an_expired_token_refreshes_once(make_fake):
    tokens = {}
    for who, module in PACKAGES.items():
        fake = make_fake()
        state = {"expired": True, "refused": 0}

        def transport(method, url, data, headers, fake=fake, state=state):
            if "metadata.google.internal" in url:
                token = "tok-1" if state["expired"] else "tok-2"
                return 200, json.dumps({"access_token": token}).encode()
            if headers.get("Authorization") == "Bearer tok-1":
                state["expired"] = False
                state["refused"] += 1
                return 401, b"{}"
            return fake.transport(method, url, data, headers)

        client = module.GCSClient(transport=transport)
        client.write_bytes("gs://est/x", b"payload")
        assert client.read_bytes("gs://est/x") == b"payload"
        tokens[who] = (client._token, state["refused"])
    assert tokens["port"] == tokens["jax"] == ("tok-2", 1)


def test_fetch_local_stages_by_generation_into_the_jax_cache(make_fake, tmp_path, monkeypatch):
    fake = make_fake()
    for module in PACKAGES.values():
        monkeypatch.setattr(module, "_default_client", _client(module, fake))
    storage.gcs_client().write_bytes("gs://est/data/x.csv", b"hello")
    first = jax_fetch_local("gs://est/data/x.csv", workdir=tmp_path)
    media = sum("media" in c for c in _calls(fake))
    # The port's cache key is the JAX package's: it finds the JAX copy
    # (a stat, no download), and so does a second fetch of its own.
    for _ in range(2):
        assert fetch_local("gs://est/data/x.csv", workdir=tmp_path) == first
    assert sum("media" in c for c in _calls(fake)) == media
    # A re-staged object is a new generation: fetched again.
    storage.gcs_client().write_bytes("gs://est/data/x.csv", b"hello v2")
    again = fetch_local("gs://est/data/x.csv", workdir=tmp_path)
    assert again != first and again.read_bytes() == b"hello v2"
    assert jax_fetch_local("gs://est/data/x.csv", workdir=tmp_path) == again
    local = tmp_path / "y.csv"
    local.write_bytes(b"z")
    assert fetch_local(local) == local


def test_csv_readers_stage_gs_paths(tmp_path, monkeypatch):
    install_fake_bucket(monkeypatch, tmp_path / "home")
    columns, labels = generate_synthetic(300, seed=3)
    write_csv_columns(tmp_path / "curated.csv", columns, labels)
    storage.gcs_client().write_bytes("gs://est/curated.csv",
                                     (tmp_path / "curated.csv").read_bytes())
    got_cols, got_labels = load_csv_columns("gs://est/curated.csv", require_target=True)
    want_cols, want_labels = jax_load_csv_columns("gs://est/curated.csv", require_target=True)
    assert got_cols == want_cols
    np.testing.assert_array_equal(got_labels, want_labels)
    np.testing.assert_array_equal(got_labels, labels)
    chunks = list(iter_csv_chunks("gs://est/curated.csv", chunk_rows=128, require_target=True))
    assert [len(c["sex"]) for c, _ in chunks] == [128, 128, 44]
    np.testing.assert_array_equal(np.concatenate([lab for _, lab in chunks]), labels)


# ------------------------------------------------------------ registry
def _bundle(root: Path, seed: int) -> Path:
    """A stand-in bundle directory: the registry copies bytes."""
    directory = root / f"bundle{seed}"
    directory.mkdir(parents=True)
    (directory / "manifest.json").write_text(json.dumps({"flavor": "test", "seed": seed}))
    (directory / "params.msgpack").write_bytes(bytes(range(seed, seed + 64)))
    return directory


def _strip_times(versions):
    return [{k: v for k, v in e.items() if not k.endswith(("_at", "_since"))} for e in versions]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_bucket_registry_written_by_one_package_is_read_by_the_other(
        writer, make_fake, tmp_path):
    fake = make_fake()
    classes = {"jax": JaxRegistry, "port": ModelRegistry}
    reader = "port" if writer == "jax" else "jax"
    registries = {
        who: cls("gs://est/registry/", client=_client(PACKAGES[who], fake),
                 cache_dir=tmp_path / f"cache-{who}")
        for who, cls in classes.items()
    }
    bundles = [_bundle(tmp_path, seed) for seed in (1, 2)]
    # An orphan of a crashed upload: the next version numbers past it.
    registries[writer]._client.write_bytes("gs://est/registry/m/versions/3/orphan", b"x")
    assert registries[writer].register("m", bundles[0], tags={"run": "r1"}) == "models:/m/4"
    assert registries[reader].register("m", bundles[1]) == "models:/m/5"
    registries[reader].set_stage("m", 4, "production")
    registries[writer].set_stage("m", 5, "staging")
    assert (_strip_times(registries["port"].list_versions("m"))
            == _strip_times(registries["jax"].list_versions("m")))
    for who, registry in registries.items():
        for stage, bundle in (("production", bundles[0]), ("staging", bundles[1]),
                              ("latest", bundles[1]), ("4", bundles[0])):
            local = registry.resolve("m", stage)
            for name in ("manifest.json", "params.msgpack"):
                assert (local / name).read_bytes() == (bundle / name).read_bytes(), (who, stage)
        assert registry.resolve_uri("models:/m/production").name == "4"
    # The cache layout is the JAX package's: <cache>/<sha256(root)[:16]>/<name>/<v>.
    cached = {who: sorted(p.relative_to(tmp_path / f"cache-{who}").as_posix()
                          for p in (tmp_path / f"cache-{who}").glob("*/m/*"))
              for who in classes}
    assert cached["port"] == cached["jax"] and len(cached["port"]) == 2
    for registry in registries.values():
        with pytest.raises(ValueError, match="bucket lifecycle rules"):
            registry.gc("m")
    with pytest.raises(KeyError, match="has no version 9"):
        registries["port"].resolve("m", "9")


def test_the_cli_reads_and_writes_a_bucket_registry(tmp_path, monkeypatch, capsys):
    install_fake_bucket(monkeypatch, tmp_path / "home")
    bundle = _bundle(tmp_path, 7)
    root = "registry.root=gs://est/reg"
    capsys.readouterr()
    assert main(["register", root, f"data.train_path={bundle}"]) == 0
    assert capsys.readouterr().out.strip() == f"models:/{NAME}/1"
    assert main(["promote", root, "registry.promote_version=1",
                 "registry.promote_stage=production"]) == 0
    assert json.loads(capsys.readouterr().out) == {
        "model": NAME, "version": 1, "stage": "production"}
    assert main(["versions", root]) == 0
    (entry,) = json.loads(capsys.readouterr().out)
    assert entry["stage"] == "production" and entry["version"] == 1
    with pytest.raises(SystemExit, match="bucket lifecycle rules"):
        main(["gc", root])
    # The registry cache is the JAX package's, under the moved HOME.
    resolved = JaxRegistry("gs://est/reg").resolve(NAME, "production")
    assert resolved.is_relative_to(tmp_path / "home" / ".cache" / "mlops_tpu" / "registry")
    assert (resolved / "params.msgpack").read_bytes() == (bundle / "params.msgpack").read_bytes()


# ---------------------------------------------------------------- tune
TUNE = ["data.rows=1200", "model.hidden_dims=16,16", "model.embed_dim=4",
        "model.precision=f32", "train.batch_size=64", "hpo.trials=2", "hpo.steps=12",
        "train.device=cpu"]


@pytest.fixture()
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_tune_from_a_bucket_equals_tune_from_local_paths(tmp_path, monkeypatch, capsys,
                                                         few_torch_threads):
    install_fake_bucket(monkeypatch, tmp_path / "home")
    columns, labels = generate_synthetic(1200, seed=11)
    csv = tmp_path / "curated.csv"
    write_csv_columns(csv, columns, labels)
    storage.gcs_client().write_bytes("gs://est/data/curated.csv", csv.read_bytes())
    runs = {}
    for where, data, registry in (
        ("local", csv, tmp_path / "registry"),
        ("bucket", "gs://est/data/curated.csv", "gs://est/registry"),
    ):
        capsys.readouterr()
        assert main(["tune", *TUNE, f"data.train_path={data}", f"registry.root={registry}",
                     f"registry.run_root={tmp_path / 'runs'}", f"registry.run_name={where}"]) == 0
        runs[where] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[where]["resolved"] = ModelRegistry(registry).resolve(NAME, "1")
    local, bucket = runs["local"], runs["bucket"]
    assert bucket["model_uri"] == local["model_uri"] == f"models:/{NAME}/1"
    assert (bucket["best_trial"], bucket["metrics"]) == (local["best_trial"], local["metrics"])
    for name in ("params.msgpack", "preprocess.npz", "monitor.npz"):
        assert ((bucket["resolved"] / name).read_bytes()
                == (local["resolved"] / name).read_bytes()), name
    # The JAX package resolves the same version from the bucket.
    jax_local = JaxRegistry("gs://est/registry").resolve(NAME, "1")
    assert (jax_local / "params.msgpack").read_bytes() == \
        (local["resolved"] / "params.msgpack").read_bytes()
