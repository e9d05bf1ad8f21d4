"""The port's model registry (``mlops_tpu_torch/bundle/registry.py``)
and its CLI commands against the JAX package's, on the CPU, both
directions on one root: what either package registers, the other
resolves, promotes and prunes; ``serve``, ``predict-file`` and
``score-batch`` resolve a stage through the registry; ``synth`` writes
the JAX package's bytes and ``validate`` gives its counts and exit code.

Bundles: a small f32 mlp (hidden (16, 16), embed 4) with numpy-seeded
weights, written by the port's ``save_exact_bundle`` from 2,000 synthetic
rows. Predictions of a resolved bundle must equal those of the directory
itself exactly (the same program on the same bytes)."""

import json
import shutil
from pathlib import Path

import pytest

from mlops_tpu.bundle.registry import ModelRegistry as JaxRegistry
from mlops_tpu.bundle.registry import parse_model_uri as jax_parse_model_uri
from mlops_tpu.cli import main as jax_main
from mlops_tpu_torch.bundle import save_exact_bundle
from mlops_tpu_torch.bundle.registry import STAGES, ModelRegistry, parse_model_uri
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import ModelConfig
from mlops_tpu_torch.data import Preprocessor, generate_synthetic
from mlops_tpu_torch.models import build_model, init_params
from mlops_tpu_torch.monitor.state import fit_monitor

NAME = "credit-default-uci-custom"


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Two small exact-tier bundles (different weights)."""
    root = tmp_path_factory.mktemp("bundles")
    columns, _ = generate_synthetic(2000, seed=5)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=256)
    config = ModelConfig(family="mlp", hidden_dims=(16, 16), embed_dim=4, precision="f32")
    out = []
    for seed in (0, 1):
        directory = root / f"bundle_{seed}"
        save_exact_bundle(
            directory, config, init_params(build_model(config), seed), prep, monitor,
            calibration={"temperature": 1.1}, tags={"seed": str(seed)},
        )
        out.append(directory)
    return out


def _strip_times(versions):
    return [{k: v for k, v in e.items() if not k.endswith(("_at", "_since"))} for e in versions]


# ---------------------------------------------------------------- uris
@pytest.mark.parametrize("uri", [
    "models:/credit/3", "models:/credit/production", "models:/a/latest",
    "models:/credit", "models://3", "runs:/abc/model", "credit/3",
])
def test_model_uris_parse_as_the_jax_package_parses_them(uri):
    try:
        want = jax_parse_model_uri(uri)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            parse_model_uri(uri)
        assert str(got.value) == str(err)
    else:
        assert parse_model_uri(uri) == want


# ------------------------------------------------------- both directions
def test_a_registry_written_by_either_package_is_read_by_the_other(bundles, tmp_path):
    root = tmp_path / "registry"
    jax_reg, reg = JaxRegistry(root), ModelRegistry(root)
    assert jax_reg.register(NAME, bundles[0], tags={"by": "jax"}) == f"models:/{NAME}/1"
    assert reg.register(NAME, bundles[1], tags={"by": "port"}) == f"models:/{NAME}/2"
    assert jax_reg.register(NAME, bundles[0]) == f"models:/{NAME}/3"
    assert reg.list_versions(NAME) == jax_reg.list_versions(NAME)
    assert [v["tags"] for v in reg.list_versions(NAME)] == [{"by": "jax"}, {"by": "port"}, {}]
    for key in ("latest", "1", "2", "3"):
        assert reg.resolve(NAME, key) == jax_reg.resolve(NAME, key)
    assert reg.resolve_uri(f"models:/{NAME}/2") == jax_reg.resolve_uri(f"models:/{NAME}/2")
    assert (reg.resolve(NAME, "2") / "manifest.json").read_bytes() == (
        bundles[1] / "manifest.json").read_bytes()
    # Unknown versions, stages nobody holds, unknown words, unknown models.
    for model, key in ((NAME, "9"), (NAME, "staging"), (NAME, "prod"), ("other", "latest")):
        with pytest.raises(KeyError) as want:
            jax_reg.resolve(model, key)
        with pytest.raises(KeyError) as got:
            reg.resolve(model, key)
        assert str(got.value) == str(want.value)


def test_set_stage_keeps_one_holder_across_the_packages(bundles, tmp_path):
    root = tmp_path / "registry"
    jax_reg, reg = JaxRegistry(root), ModelRegistry(root)
    for b in (bundles[0], bundles[1], bundles[0]):
        reg.register(NAME, b)
    reg.set_stage(NAME, 1, "production")
    assert jax_reg.resolve(NAME, "production") == reg.resolve(NAME, "1")
    jax_reg.set_stage(NAME, 2, "production")  # archives version 1
    reg.set_stage(NAME, 3, "staging")
    got = {v["version"]: v for v in reg.list_versions(NAME)}
    assert [got[v]["stage"] for v in (1, 2, 3)] == ["none", "production", "staging"]
    assert "production_since" in got[1] and "production_since" in got[2]
    assert "staging_since" in got[3]
    assert reg.resolve(NAME, "production") == jax_reg.resolve(NAME, "2")
    reg.set_stage(NAME, 3, "production")
    assert [v["stage"] for v in jax_reg.list_versions(NAME)] == ["none", "none", "production"]
    for bad in ((NAME, 1, "prod"), (NAME, 9, "staging")):
        errors = []
        for r in (jax_reg, reg):
            with pytest.raises((KeyError, ValueError)) as err:
                r.set_stage(*bad)
            errors.append((type(err.value), str(err.value)))
        assert errors[0] == errors[1]
    assert STAGES == ("none", "staging", "production")


def test_gc_prunes_as_the_jax_package_prunes(bundles, tmp_path):
    """The same registry pruned by each package: crash orphans and
    abandoned copies, then unstaged versions beyond the newest one; the
    staged version survives."""
    src = tmp_path / "src"
    reg = ModelRegistry(src)
    for b in (bundles[0], bundles[1], bundles[0], bundles[1]):
        reg.register(NAME, b)
    reg.set_stage(NAME, 1, "production")
    shutil.copytree(bundles[0], src / NAME / "versions" / "7")  # an orphan
    (src / NAME / "versions" / ".incoming-dead").mkdir()
    results = {}
    for who, cls in (("jax", JaxRegistry), ("port", ModelRegistry)):
        root = tmp_path / who
        shutil.copytree(src, root)
        r = cls(root)
        first = r.gc(NAME)
        second = r.gc(NAME, keep_unstaged=1)
        results[who] = (
            first, second, _strip_times(r.list_versions(NAME)),
            sorted(p.name for p in (root / NAME / "versions").iterdir()),
        )
    assert results["port"] == results["jax"]
    first, second, versions, dirs = results["port"]
    assert first == {"orphans_removed": [7], "versions_removed": []}
    assert second == {"orphans_removed": [], "versions_removed": [2, 3]}
    assert [v["version"] for v in versions] == [1, 4] and dirs == ["1", "4"]
    # The next registration never reuses a pruned or orphaned number.
    assert ModelRegistry(tmp_path / "port").register(NAME, bundles[0]).endswith("/5")


def test_a_gs_root_serves_its_production_stage_and_refuses_gc_as_jax(
        bundles, tmp_path, capsys, monkeypatch):
    """The registry commands on a bucket (the deployed Job's root): the
    JAX package registers and promotes, the port's ``predict-file``
    resolves production from the bucket and answers as on the bundle
    directory; ``gc`` exits in both with the JAX message."""
    from torch_gcs import install_fake_bucket

    install_fake_bucket(monkeypatch, tmp_path / "home")
    root = "registry.root=gs://bucket/models"
    for entry, argv in ((jax_main, ["register", root, f"data.train_path={bundles[0]}"]),
                        (main, ["register", root, f"data.train_path={bundles[1]}"]),
                        (jax_main, ["promote", root, "registry.promote_version=1",
                                    "registry.promote_stage=production"])):
        capsys.readouterr()
        assert entry(argv) == 0
    csv = tmp_path / "rows.csv"
    from mlops_tpu_torch.data import write_csv_columns

    write_csv_columns(csv, *generate_synthetic(50, seed=9))
    answers = {}
    for model_dir, extra in (("production", [root]), (str(bundles[0]), [])):
        capsys.readouterr()
        assert main(["predict-file", f"data.train_path={csv}", "serve.device=cpu",
                     f"serve.model_directory={model_dir}", *extra]) == 0
        answers[model_dir] = json.loads(capsys.readouterr().out)
    assert answers["production"] == answers[str(bundles[0])]
    for entry in (jax_main, main):
        with pytest.raises(SystemExit, match="use bucket lifecycle rules") as err:
            entry(["gc", root])
        assert "gc supports the local registry backend" in str(err.value)


# ----------------------------------------------------------------- CLI
def _out(entry, argv, capsys, code=0):
    capsys.readouterr()
    assert entry(argv) == code
    return capsys.readouterr().out.strip()


def test_the_registry_commands_print_the_jax_output(bundles, tmp_path, capsys):
    roots = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    outs = {}
    for who, entry in (("jax", jax_main), ("port", main)):
        r = [f"registry.root={roots[who]}"]
        outs[who] = [
            _out(entry, ["register", f"data.train_path={bundles[0]}", *r], capsys),
            _out(entry, ["register", f"data.train_path={bundles[1]}", *r], capsys),
            _out(entry, ["register", f"data.train_path={bundles[1]}", *r], capsys),
            json.loads(_out(entry, ["promote", "registry.promote_version=2",
                                    "registry.promote_stage=production", *r], capsys)),
            json.loads(_out(entry, ["promote", "registry.promote_version=3", *r], capsys)),
            _out(entry, ["register", f"data.train_path={bundles[0]}", *r], capsys),
            _strip_times(json.loads(_out(entry, ["versions", *r], capsys))),
            json.loads(_out(entry, ["gc", "registry.gc_keep=0", *r], capsys)),
            json.loads(_out(entry, ["gc", "registry.gc_keep=1", *r], capsys)),
        ]
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == f"models:/{NAME}/1"
    assert outs["port"][3] == {"model": NAME, "version": 2, "stage": "production"}
    assert outs["port"][4] == {"model": NAME, "version": 3, "stage": "staging"}
    assert [v["stage"] for v in outs["port"][6]] == ["none", "production", "staging", "none"]
    assert outs["port"][8] == {"model": NAME, "orphans_removed": [], "versions_removed": [1]}
    with pytest.raises(SystemExit, match="registry.promote_version"):
        main(["promote", f"registry.root={roots['port']}"])
    with pytest.raises(SystemExit, match="data.train_path"):
        main(["register", f"registry.root={roots['port']}"])


# ---------------------------------------------- commands resolve a stage
@pytest.fixture(scope="module")
def staged(bundles, tmp_path_factory):
    """A JAX-written registry whose production stage holds version 2."""
    root = tmp_path_factory.mktemp("staged") / "registry"
    jax_reg = JaxRegistry(root)
    for b in bundles:
        jax_reg.register(NAME, b)
    jax_reg.set_stage(NAME, 2, "production")
    csv = root.parent / "rows.csv"
    from mlops_tpu_torch.data import write_csv_columns

    columns, labels = generate_synthetic(300, seed=9)
    write_csv_columns(csv, columns, labels)
    return root, csv


@pytest.mark.parametrize("key", ["production", "2", "latest"])
def test_predict_file_and_score_batch_resolve_through_the_registry(bundles, staged, key, capsys):
    root, csv = staged
    common = [f"data.train_path={csv}", "serve.device=cpu"]
    for command in ("predict-file", "score-batch"):
        direct = json.loads(_out(main, [command, *common,
                                        f"serve.model_directory={bundles[1]}"], capsys))
        resolved = json.loads(_out(main, [command, *common, f"registry.root={root}",
                                          f"serve.model_directory={key}"], capsys))
        for timing in ("elapsed_s", "rows_per_s", "pipeline"):  # clocks
            direct.pop(timing, None), resolved.pop(timing, None)
        assert resolved == direct, command


def test_serve_resolves_a_stage_and_model_directory(bundles, staged, monkeypatch):
    """``serve`` hands the engine the bundle the stage resolves to, from
    the config and from ``MODEL_DIRECTORY``; an unheld stage fails with
    the registry's message."""
    from mlops_tpu_torch.serve import server

    root, _ = staged
    served = []
    monkeypatch.setattr(server, "serve_forever", lambda engine, cfg: served.append(engine))
    args = ["serve", f"registry.root={root}", "serve.device=cpu", "serve.warmup_batch_sizes=1"]
    assert main([*args, "serve.model_directory=production"]) == 0
    monkeypatch.setenv("MODEL_DIRECTORY", "1")
    assert main(args) == 0
    monkeypatch.delenv("MODEL_DIRECTORY")
    want = [Path(b) for b in (bundles[1], bundles[0])]
    for engine, bundle_dir in zip(served, want):
        probs = engine.predict_records([{"age": 30.0}, {"sex": "male"}])["predictions"]
        from mlops_tpu_torch.bundle import load_bundle
        from mlops_tpu_torch.serve.engine import InferenceEngine

        ref = InferenceEngine(load_bundle(bundle_dir), buckets=(1,), device="cpu")
        assert probs == ref.predict_records([{"age": 30.0}, {"sex": "male"}])["predictions"]
    with pytest.raises(KeyError, match="no version in stage 'staging'"):
        main([*args, "serve.model_directory=staging"])


# --------------------------------------------------------- synth, validate
def test_synth_writes_the_jax_package_bytes(tmp_path, capsys):
    outs = {}
    for who, entry in (("jax", jax_main), ("port", main)):
        path = tmp_path / f"{who}.csv"
        outs[who] = _out(entry, ["synth", "data.rows=700", "data.seed=11",
                                 f"data.train_path={path}"], capsys)
    assert outs["port"] == outs["jax"].replace("jax.csv", "port.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def _dirty_csv(path: Path, bad_label: bool, target: bool = True):
    from mlops_tpu_torch.data import write_csv_columns

    columns, labels = generate_synthetic(400, seed=2)
    columns["sex"][3] = "unknown"
    columns["education"][5] = "phd"
    columns["age"][7] = float("nan")
    columns["credit_limit"][9] = float("nan")
    write_csv_columns(path, columns, labels if target else None)
    if bad_label:
        lines = path.read_text().splitlines()
        lines[4] = lines[4].rsplit(",", 1)[0] + ",maybe"
        path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["clean", "dirty", "bad_label", "no_target"])
def test_validate_counts_and_exits_as_the_jax_package(tmp_path, capsys, case):
    path = tmp_path / f"{case}.csv"
    if case == "clean":
        from mlops_tpu_torch.data import write_csv_columns

        write_csv_columns(path, *generate_synthetic(300, seed=4))
    else:
        _dirty_csv(path, bad_label=case == "bad_label", target=case != "no_target")
    got = {}
    for who, entry in (("jax", jax_main), ("port", main)):
        capsys.readouterr()
        code = entry(["validate", f"data.train_path={path}"])
        got[who] = (code, json.loads(capsys.readouterr().out.strip()))
    assert got["port"] == got["jax"]
    code, report = got["port"]
    assert code == (0 if case == "clean" else 2) and report["ok"] == (case == "clean")
    if case == "dirty":
        assert report["oov_categorical"] == {"sex": 1, "education": 1}
        assert report["numeric_imputed"] == {"credit_limit": 1, "age": 1}
    assert report["labels"] == {"clean": "ok", "dirty": "ok", "no_target": "absent"}.get(
        case, report["labels"])


def test_validate_reads_a_gs_parquet_file_as_the_jax_package(tmp_path, capsys, monkeypatch):
    pytest.importorskip("pyarrow")
    from mlops_tpu_torch.data import load_csv_columns
    from mlops_tpu_torch.data.parquet import write_parquet_columns
    from mlops_tpu_torch.utils import storage
    from torch_gcs import install_fake_bucket

    install_fake_bucket(monkeypatch, tmp_path / "home")
    _dirty_csv(tmp_path / "dirty.csv", bad_label=False)
    write_parquet_columns(tmp_path / "dirty.parquet",
                          *load_csv_columns(tmp_path / "dirty.csv", require_target=True))
    storage.gcs_client().write_bytes("gs://bucket/dirty.parquet",
                                     (tmp_path / "dirty.parquet").read_bytes())
    got = {}
    for who, entry in (("jax", jax_main), ("port", main)):
        capsys.readouterr()
        code = entry(["validate", "data.train_path=gs://bucket/dirty.parquet"])
        got[who] = (code, json.loads(capsys.readouterr().out.strip()))
    assert got["port"] == got["jax"]
    code, report = got["port"]
    assert code == 2 and report["rows"] == 400 and report["labels"] == "ok"
    assert report["oov_categorical"] == {"sex": 1, "education": 1}
    assert report["numeric_imputed"] == {"credit_limit": 1, "age": 1}
