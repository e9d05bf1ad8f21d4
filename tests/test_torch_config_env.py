"""The port's environment layer (ROADMAP C5) and its refusal of the keys it
has not ported, against the JAX package's ``load_config``, on the CPU.

Both loaders get one environment dict. Shared keys come out equal,
tuples included; a malformed or unknown ``MLOPS_TPU_*`` key warns in both
with the same text. Every key of the JAX config tree that the port has not
ported (the JAX dataclass fields minus the port's ported ones, enumerated
here from the two trees: the event-loop lag sanitizer's two ``serve``
keys) is accepted at its JAX default and refused, naming its ROADMAP
item, at any other value, whether the environment, the TOML or a CLI
override sets it. The thirteen keys of the ring plane, its engine replica
set, the tenant fleet and the warm start (``serve.workers`` and its
geometry, ``serve.engine_replicas``, ``serve.replica_affinity_slack``,
``serve.tenants_path``, ``cache.dir``, ``cache.warmup_workers``) are
ported, and so are the ``trace``, ``slo`` and ``autotune`` sections: off
their defaults, each layer gives the JAX loader's value."""

import dataclasses
import warnings

import pytest

from mlops_tpu.config import Config as JaxConfig
from mlops_tpu.config import load_config as jax_load_config
from mlops_tpu_torch.cli import main
from mlops_tpu_torch.config import Config, load_config


def _fields(config) -> dict:
    return {
        f"{section.name}.{f.name}": (f, getattr(getattr(config, section.name), f.name))
        for section in dataclasses.fields(config)
        for f in dataclasses.fields(getattr(config, section.name))
    }


JAX_FIELDS = _fields(JaxConfig())
PORT_FIELDS = _fields(Config())
PORTED = {k for k, (f, _) in PORT_FIELDS.items() if "unported" not in f.metadata}
JAX_ONLY = sorted(set(JAX_FIELDS) - PORTED)
ITEM = {k: f.metadata["unported"] for k, (f, _) in PORT_FIELDS.items() if k not in PORTED}


def _other_value(default):
    """A value away from the JAX default, as an override string."""
    if isinstance(default, bool):
        return str(not default).lower()
    if isinstance(default, (int, float)):
        return str(default + 2)
    return f"{default}elsewhere"


def _env_key(key: str) -> str:
    return "MLOPS_TPU_" + key.replace(".", "_").upper()


def _both(env: dict, overrides=()):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax = jax_load_config(overrides=list(overrides), env=env)
        port = load_config(list(overrides), env=env)
    return jax, port, sorted(str(w.message) for w in caught)


def test_the_unported_keys_are_the_jax_keys_the_port_lacks():
    assert sorted(ITEM) == JAX_ONLY
    assert set(PORT_FIELDS) - set(JAX_FIELDS) == {"serve.device", "train.device"}
    for key in JAX_ONLY:
        assert PORT_FIELDS[key][1] == JAX_FIELDS[key][1], key  # the JAX default
    assert {k.split(".")[0] for k in JAX_ONLY} == {"serve"}
    assert not [k for k, item in ITEM.items() if item in ("A3", "A4")]
    assert sum(k.startswith("serve.") for k in JAX_ONLY) == 2
    assert {k for k, item in ITEM.items() if item == "A12"} == set(JAX_ONLY) == {
        "serve.loop_lag_monitor", "serve.loop_lag_slow_ms"}


def test_shared_keys_come_out_equal():
    env = {
        "MLOPS_TPU_TRAIN_STEPS": "7",
        "MLOPS_TPU_SERVE_WARMUP_BATCH_SIZES": "1,8",
        "MLOPS_TPU_SERVE_PORT": "8080",
        "MLOPS_TPU_SERVE_WORKERS": "0",
        "MLOPS_TPU_MODEL_HIDDEN_DIMS": "(64, 32)",
        "MLOPS_TPU_HPO_ARCHITECTURES": "hidden_dims=16;family=ft_transformer,token_dim=32",
        "MLOPS_TPU_HPO_LR_LOG10": "-3,-2.5",
        "MLOPS_TPU_TRAIN_KEEP_BEST": "no",
        "MLOPS_TPU_DATA_VALID_FRACTION": "0.25",
        "MLOPS_TPU_REGISTRY_ROOT": "gs://bucket/models",
        "MLOPS_TPU_CACHE_WARMUP_WORKERS": "0",
    }
    jax, port, warned = _both(env)
    assert warned == []
    assert port.train.steps == jax.train.steps == 7
    assert port.serve.warmup_batch_sizes == jax.serve.warmup_batch_sizes == (1, 8)
    for key in PORTED & set(JAX_FIELDS):
        section, field = key.split(".")
        assert (getattr(getattr(port, section), field)
                == getattr(getattr(jax, section), field)), key
    # The CLI override still wins over the environment, as in JAX.
    jax, port, _ = _both(env, ["train.steps=9"])
    assert port.train.steps == jax.train.steps == 9


@pytest.mark.parametrize("key,kind", [
    ("MLOPS_TPU_COORDINATOR", "malformed"),
    ("MLOPS_TPU_TEST_CACHE", "unknown"),
    ("MLOPS_TPU_SERVE_NOPE", "unknown"),
    ("MLOPS_TPU_NOPE_NOPE", "unknown"),
])
def test_malformed_and_unknown_keys_warn_in_both(key, kind):
    jax, port, warned = _both({key: "1", "MLOPS_TPU_TRAIN_STEPS": "3"})
    assert warned == [f"ignoring {kind} env override {key}"] * 2
    assert port.train.steps == jax.train.steps == 3


@pytest.mark.parametrize("key", JAX_ONLY)
def test_a_key_the_port_lacks_is_refused_off_its_default(key, tmp_path):
    section, field = key.split(".")
    default = JAX_FIELDS[key][1]
    item = ITEM[key]
    other = _other_value(default)
    jax_config = jax_load_config(overrides=[f"{key}={other}"], env={})
    assert getattr(getattr(jax_config, section), field) != default  # JAX takes it
    toml = tmp_path / "c.toml"
    toml.write_text(f'[{section}]\n{field} = {other if not isinstance(default, str) else repr(other)}\n')
    for layer in (
        lambda: load_config(env={_env_key(key): other}),
        lambda: load_config([f"{key}={other}"], env={}),
        lambda: load_config(toml_path=toml, env={}),
    ):
        with pytest.raises(ValueError, match=rf"{key}=.* refused: .*ROADMAP {item}"):
            layer()
    # At its default it changes nothing, from every layer.
    raw = str(default).lower() if isinstance(default, bool) else str(default)
    config = load_config([f"{key}={raw}"], env={_env_key(key): raw})
    assert getattr(getattr(config, section), field) == default


RING_AND_WARM_START = [
    "serve.workers", "serve.ring_slots_small", "serve.ring_slots_large",
    "serve.shed_retry_after_s", "serve.engine_respawn_eta_s",
    "serve.zygote_join_deadline_s", "serve.engine_zygote_join_s",
    "serve.log_sample_rate", "cache.dir", "cache.warmup_workers",
    "serve.engine_replicas", "serve.replica_affinity_slack", "serve.tenants_path",
]
# The observability layer: every key of the JAX ``trace`` and ``slo``
# sections.
OBSERVABILITY = sorted(k for k in JAX_FIELDS if k.split(".")[0] in ("trace", "slo"))
# The traffic-shape autotuner: every key of the JAX ``autotune`` section.
AUTOTUNE = sorted(k for k in JAX_FIELDS if k.split(".")[0] == "autotune")


@pytest.mark.parametrize("key", RING_AND_WARM_START + OBSERVABILITY + AUTOTUNE)
def test_a_ported_key_matches_jax_off_its_default(key, tmp_path):
    assert key in PORTED
    section, field = key.split(".")
    default = JAX_FIELDS[key][1]
    assert PORT_FIELDS[key][1] == default
    other = _other_value(default)
    toml = tmp_path / "c.toml"
    toml.write_text(f'[{section}]\n{field} = {other if not isinstance(default, str) else repr(other)}\n')
    for kwargs in (dict(env={_env_key(key): other}), dict(overrides=[f"{key}={other}"], env={}),
                   dict(toml_path=toml, env={})):
        jax = jax_load_config(**kwargs)
        port = load_config(**kwargs)
        got = getattr(getattr(port, section), field)
        assert got == getattr(getattr(jax, section), field) != default, kwargs


@pytest.mark.parametrize("workers", ["0", "1"])
def test_workers_zero_and_one_are_the_single_process_server(workers):
    jax, port, _ = _both({"MLOPS_TPU_SERVE_WORKERS": workers})
    assert port.serve.workers == jax.serve.workers == int(workers)


def test_the_cli_exits_naming_the_item(monkeypatch):
    """The one section left unported is A12's: its keys exit naming the
    item. The ``autotune`` section is ported: ``serve`` takes it and stops
    only at the JAX cross-section contract, with the JAX message."""
    assert len(OBSERVABILITY) == 27 and len(AUTOTUNE) == 8
    monkeypatch.setenv("MLOPS_TPU_SERVE_LOOP_LAG_MONITOR", "true")
    with pytest.raises(SystemExit, match="serve.loop_lag_monitor=True refused: .*ROADMAP A12"):
        main(["serve", "serve.device=cpu"])
    monkeypatch.delenv("MLOPS_TPU_SERVE_LOOP_LAG_MONITOR")
    monkeypatch.setenv("MLOPS_TPU_AUTOTUNE_ENABLED", "true")
    monkeypatch.setenv("MLOPS_TPU_AUTOTUNE_PLAN_DIR", "elsewhere")
    with pytest.raises(SystemExit, match="^autotune.enabled requires trace.enabled"):
        main(["serve", "serve.device=cpu"])
    assert load_config().autotune.plan_dir == jax_load_config().autotune.plan_dir == "elsewhere"


def test_the_environment_reaches_the_port_by_default(monkeypatch):
    monkeypatch.setenv("MLOPS_TPU_TRAIN_STEPS", "7")
    assert load_config().train.steps == jax_load_config().train.steps == 7
