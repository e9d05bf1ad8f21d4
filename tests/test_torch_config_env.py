"""The port's environment layer (ROADMAP C5) against the JAX package's
``load_config``, on the CPU.

Both loaders get one environment dict. Shared keys come out equal,
tuples included; a malformed or unknown ``MLOPS_TPU_*`` key warns in both
with the same text. Every key of the JAX config tree is ported (the
port's tree is the JAX tree plus ``serve.device`` and ``train.device``):
the thirteen keys of the ring plane, its engine replica set, the tenant
fleet and the warm start (``serve.workers`` and its geometry,
``serve.engine_replicas``, ``serve.replica_affinity_slack``,
``serve.tenants_path``, ``cache.dir``, ``cache.warmup_workers``), the
``trace``, ``slo`` and ``autotune`` sections and the event-loop lag
sanitizer's two ``serve`` keys: off their defaults, each layer gives the
JAX loader's value, and the sanitizer's keys arm it and validate with
the JAX messages."""

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
JAX_ONLY = sorted(set(JAX_FIELDS) - set(PORT_FIELDS))
# The event-loop lag sanitizer's keys (ROADMAP A12, the last JAX keys the
# port refused).
LOOP_LAG = ["serve.loop_lag_monitor", "serve.loop_lag_slow_ms"]


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


def test_every_jax_key_is_ported():
    assert JAX_ONLY == []
    assert set(PORT_FIELDS) - set(JAX_FIELDS) == {"serve.device", "train.device"}
    assert not [k for k, (f, _) in PORT_FIELDS.items() if f.metadata]
    for key in LOOP_LAG:
        assert PORT_FIELDS[key][1] == JAX_FIELDS[key][1], key  # the JAX default


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
    for key in set(PORT_FIELDS) & set(JAX_FIELDS):
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


@pytest.mark.parametrize("key", LOOP_LAG)
def test_the_loop_lag_keys_arm_and_validate_from_every_layer(key, tmp_path):
    """Each layer sets the key as the JAX loader does; the monitor key
    arms, and a slow threshold at 0 loads, then fails ``validate`` with
    the JAX message."""
    from mlops_tpu.config import ServeConfigError as JaxServeConfigError

    from mlops_tpu_torch.config import ServeConfigError

    section, field = key.split(".")
    value = "true" if field == "loop_lag_monitor" else "0"
    toml = tmp_path / "c.toml"
    # A float literal in the TOML: the port stores a TOML integer in a
    # float field as a float, where the JAX loader keeps the int (and its
    # message then reads "=0").
    toml.write_text(f"[{section}]\n{field} = {value if value == 'true' else '0.0'}\n")
    for kwargs in (dict(env={_env_key(key): value}), dict(overrides=[f"{key}={value}"], env={}),
                   dict(toml_path=toml, env={})):
        jax, port = jax_load_config(**kwargs), load_config(**kwargs)
        got = getattr(port.serve, field)
        assert got == getattr(jax.serve, field) != JAX_FIELDS[key][1], kwargs
        if field == "loop_lag_monitor":
            assert port.serve.validate().loop_lag_monitor is True
            continue
        with pytest.raises(JaxServeConfigError) as want:
            jax.serve.validate()
        with pytest.raises(ServeConfigError) as err:
            port.serve.validate()
        assert str(err.value) == str(want.value)
        assert "serve.loop_lag_slow_ms=0.0 must be > 0" in str(err.value)


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


@pytest.mark.parametrize("key", RING_AND_WARM_START + OBSERVABILITY + AUTOTUNE + LOOP_LAG)
def test_a_ported_key_matches_jax_off_its_default(key, tmp_path):
    assert key in PORT_FIELDS
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


def test_the_cli_takes_the_loop_lag_keys_and_stops_at_validation(monkeypatch):
    """``serve`` takes the sanitizer's keys from the environment and stops
    at the JAX validation message before any work; the ``autotune``
    section stops only at the JAX cross-section contract."""
    from mlops_tpu_torch.config import ServeConfigError

    assert len(OBSERVABILITY) == 27 and len(AUTOTUNE) == 8
    monkeypatch.setenv("MLOPS_TPU_SERVE_LOOP_LAG_MONITOR", "true")
    monkeypatch.setenv("MLOPS_TPU_SERVE_LOOP_LAG_SLOW_MS", "0")
    with pytest.raises(ServeConfigError, match=r"^serve.loop_lag_slow_ms=0.0 must be > 0"):
        main(["serve", "serve.device=cpu"])
    assert load_config().serve.loop_lag_monitor is jax_load_config().serve.loop_lag_monitor
    monkeypatch.delenv("MLOPS_TPU_SERVE_LOOP_LAG_MONITOR")
    monkeypatch.delenv("MLOPS_TPU_SERVE_LOOP_LAG_SLOW_MS")
    monkeypatch.setenv("MLOPS_TPU_AUTOTUNE_ENABLED", "true")
    monkeypatch.setenv("MLOPS_TPU_AUTOTUNE_PLAN_DIR", "elsewhere")
    with pytest.raises(SystemExit, match="^autotune.enabled requires trace.enabled"):
        main(["serve", "serve.device=cpu"])
    assert load_config().autotune.plan_dir == jax_load_config().autotune.plan_dir == "elsewhere"


def test_the_environment_reaches_the_port_by_default(monkeypatch):
    monkeypatch.setenv("MLOPS_TPU_TRAIN_STEPS", "7")
    assert load_config().train.steps == jax_load_config().train.steps == 7
