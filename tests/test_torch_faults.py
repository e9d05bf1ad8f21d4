"""The port's fault injection (``mlops_tpu_torch/faults/``) against the JAX
package's, on the CPU:

- one plan and seed over one hit sequence give identical ``fire`` /
  ``corrupt`` traces, outcomes and flipped bytes in both packages; one
  TOML plan loads into the same rules; ``MLOPS_TPU_FAULTS`` arms a
  subprocess of either package with the same trace, and a broken plan
  fails loudly in both; disarmed, a point is a no-op;
- by AST scan, every point in the port's ``POINTS`` is compiled in, and
  every JAX point is ported (``UNPORTED_POINTS`` is empty) and
  ``autotune.regrid.midswap`` fires in the port's ``apply_plan``;
- the engine's dispatch points count hits as the JAX engine's do;
- torn writes: a kill at ``lifecycle.reservoir.midwrite``,
  ``io.atomic_write.midwrite`` or ``compilecache.persist.midwrite`` in a
  subprocess leaves the prior file (the reservoir readable by the JAX
  ``SampleReservoir``) and no partial one; a corrupt read at
  ``compilecache.read`` is a counted discard and a rebuild.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from mlops_tpu import faults as jax_faults
from mlops_tpu.faults import POINTS as JAX_POINTS
from mlops_tpu.lifecycle import SampleReservoir as JaxReservoir
from mlops_tpu_torch import faults
from mlops_tpu_torch.faults import POINTS, UNPORTED_POINTS
from mlops_tpu_torch.lifecycle.retrain import SampleReservoir
from mlops_tpu_torch.ops import cuda_build
from mlops_tpu_torch.schema.features import SCHEMA
from torch_ring import ROOT, budget, make_bundle  # noqa: F401

PLANS = {
    "bernoulli": ([{"point": "serve.engine.dispatch*", "mode": "delay",
                    "probability": 0.3}], 42),
    "after_and_max_fires": ([{"point": "serve.engine.dispatch", "mode": "raise",
                              "after": 3, "max_fires": 2, "message": "device lost"}], 7),
    "stall_then_raise": ([{"point": "lifecycle.*", "mode": "delay", "max_fires": 2},
                          {"point": "lifecycle.retrain", "mode": "raise", "after": 2,
                           "exc": "OSError"}], 0),
    "corrupt": ([{"point": "compilecache.read", "mode": "corrupt", "flip_bits": 8,
                  "probability": 0.5}], 3),
    "modes_skip_each_other": ([{"point": "compilecache.*", "mode": "raise",
                                "exc": "ValueError", "probability": 0.6},
                               {"point": "compilecache.*", "mode": "corrupt",
                                "flip_bits": 3, "seed": 99}], 11),
}
HIT_POINTS = ("serve.engine.dispatch", "serve.engine.dispatch_group", "compilecache.read",
              "lifecycle.retrain", "lifecycle.shadow.evaluate", "compilecache.persist.midwrite")


def _run(module, rules, seed, hits: int = 90):
    """Drive ``module``'s points through one fixed hit sequence under the
    plan; every hit's outcome, and the plan's trace."""
    plan = module.arm(module.FaultPlan.from_rules(rules, seed=seed))
    outcomes = []
    try:
        for i in range(hits):
            point = HIT_POINTS[(i * 7 + i // 5) % len(HIT_POINTS)]
            if point == "compilecache.read" or i % 11 == 0:
                outcomes.append(module.corrupt(point, bytes(range(i % 200, i % 200 + 40))))
                continue
            try:
                module.fire(point)
                outcomes.append(None)
            except Exception as err:  # the injected raise
                outcomes.append((type(err).__name__, str(err)))
        return outcomes, plan.trace()
    finally:
        module.disarm()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_plan_gives_the_jax_trace(name):
    rules, seed = PLANS[name]
    got, trace = _run(faults, rules, seed)
    want, jax_trace = _run(jax_faults, rules, seed)
    assert trace == jax_trace
    assert got == want
    assert trace, "the plan never fired"


def test_decision_hashes_are_the_jax_ones():
    from mlops_tpu.faults.injector import _decision_hash as jax_hash
    from mlops_tpu_torch.faults.injector import _decision_hash

    for args in [(0, "a", "a", 0), (42, "serve.*", "serve.engine.dispatch", 17),
                 (2**40, "x", "x#bit", 3)]:
        assert _decision_hash(*args) == jax_hash(*args)


PLAN_TOML = """\
seed = 42
[[fault]]
point = "serve.engine.dispatch*"
mode = "delay"
delay_s = 0.0
probability = 0.25

[[fault]]
point = "lifecycle.retrain"
mode = "raise"
after = 1
max_fires = 2
exc = "OSError"
message = "retrain failure"

[[fault]]
point = "compilecache.read"
mode = "corrupt"
flip_bits = 4
seed = 5
"""


def test_one_toml_plan_loads_into_the_same_rules(tmp_path):
    path = tmp_path / "chaos.toml"
    path.write_text(PLAN_TOML)
    plan, jax_plan = faults.load_plan(path), jax_faults.load_plan(path)
    assert plan.seed == jax_plan.seed == 42
    assert ([dataclasses.asdict(r) for r in plan.rules]
            == [dataclasses.asdict(r) for r in jax_plan.rules])


_ARMED = """
import json
from {package} import faults
out = []
for i in range(40):
    try:
        faults.fire(("serve.engine.dispatch", "lifecycle.retrain")[i % 2])
    except OSError as err:
        out.append(str(err))
out.append(faults.corrupt("compilecache.read", bytes(range(64))).hex())
print(json.dumps([faults.armed(), faults.active_plan().trace(), out]))
"""


def test_the_environment_arms_a_subprocess_of_either_package(tmp_path):
    path = tmp_path / "chaos.toml"
    path.write_text(PLAN_TOML)
    runs = {}
    for package in ("mlops_tpu_torch", "mlops_tpu"):
        out = subprocess.run([sys.executable, "-c", _ARMED.format(package=package)],
                             capture_output=True, text=True, cwd=ROOT, timeout=120,
                             env=dict(os.environ, PYTHONPATH=str(ROOT),
                                      MLOPS_TPU_FAULTS=str(path)))
        assert out.returncode == 0, out.stderr
        runs[package] = json.loads(out.stdout.strip().splitlines()[-1])
    assert runs["mlops_tpu_torch"] == runs["mlops_tpu"]
    armed, trace, outcomes = runs["mlops_tpu_torch"]
    assert armed and outcomes[:2] == ["retrain failure", "retrain failure"]
    assert [t[0] for t in trace].count("lifecycle.retrain") == 2


def test_a_broken_plan_fails_loudly_in_both_packages(tmp_path):
    path = tmp_path / "broken.toml"
    path.write_text('[[fault]]\npoint = "x"\nmode = "explode"\n')
    for package in ("mlops_tpu_torch", "mlops_tpu"):
        out = subprocess.run([sys.executable, "-c", f"from {package} import faults"],
                             capture_output=True, text=True, cwd=ROOT, timeout=120,
                             env=dict(os.environ, PYTHONPATH=str(ROOT),
                                      MLOPS_TPU_FAULTS=str(path)))
        assert out.returncode != 0 and "fault mode 'explode'" in out.stderr, package


def test_disarmed_points_are_no_ops():
    faults.disarm()
    assert not faults.armed() and faults.active_plan() is None
    data = b"kernel library bytes"
    assert faults.fire("serve.engine.dispatch") is None
    assert faults.corrupt("compilecache.read", data) is data


@pytest.mark.parametrize("bad", [
    {"mode": "explode"}, {"mode": "delay", "probability": 1.5},
    {"mode": "raise", "exc": "SystemExit"}, {"mode": "delay", "after": -1},
    {"mode": "delay", "max_fires": 0}, {"mode": "delay", "delay_s": -1.0},
    {"mode": "corrupt", "flip_bits": 0},
])
def test_a_bad_rule_is_refused_with_the_jax_message(bad):
    with pytest.raises(ValueError) as err:
        faults.FaultRule(point="p", **bad)
    with pytest.raises(ValueError) as jax_err:
        jax_faults.FaultRule(point="p", **bad)
    assert str(err.value) == str(jax_err.value)


# ----------------------------------------------------------------- points
def _compiled_points(package: Path) -> dict[str, set[str]]:
    """Point name -> the files that fire or corrupt it, from the AST."""
    found: dict[str, set[str]] = {}
    for path in package.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("fire", "corrupt")
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "faults"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                found.setdefault(node.args[0].value, set()).add(
                    str(path.relative_to(package.parent)))
    return found


def test_every_listed_point_is_compiled_into_the_port():
    compiled = _compiled_points(ROOT / "mlops_tpu_torch")
    assert set(compiled) == set(POINTS)


@pytest.mark.parametrize("point", sorted(JAX_POINTS))
def test_every_jax_point_is_ported_or_queued(point):
    assert point in _compiled_points(ROOT / "mlops_tpu")
    assert point in POINTS and UNPORTED_POINTS == {}
    assert point in _compiled_points(ROOT / "mlops_tpu_torch")
    if point == "autotune.regrid.midswap":
        assert _compiled_points(ROOT / "mlops_tpu_torch")[point] == {
            "mlops_tpu_torch/autotune/apply.py"}


def test_the_port_adds_no_point_of_its_own():
    assert set(POINTS) | set(UNPORTED_POINTS) == set(JAX_POINTS)
    assert not set(POINTS) & set(UNPORTED_POINTS)


# --------------------------------------------------- the engine's points
@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    return make_bundle(tmp_path_factory.mktemp("faults"))


def _dispatches(module, engine, rules):
    """Solo dispatches (an empty request among them, which is no
    dispatch) and grouped ones under the plan: which raised."""
    cat = np.zeros((1, SCHEMA.num_categorical), np.int32)
    num = np.zeros((1, SCHEMA.num_numeric), np.float32)
    plan = module.arm(module.FaultPlan.from_rules(rules, seed=1))
    out = []
    try:
        for call in ["solo", "empty", "solo", "group", "solo", "group", "group"]:
            try:
                if call == "group":
                    engine.fetch_group(engine.dispatch_group_arrays([(cat, num), (cat, num)]))
                elif call == "empty":
                    engine.dispatch_arrays(cat[:0], num[:0])
                else:
                    engine.fetch_arrays(engine.dispatch_arrays(cat, num))
                out.append(None)
            except Exception as err:
                out.append(str(err))
        return out, plan.trace()
    finally:
        module.disarm()


def test_the_dispatch_points_count_hits_as_the_jax_engine_does(bundle_dir):
    from mlops_tpu.bundle import load_bundle as jax_load_bundle
    from mlops_tpu.serve.engine import InferenceEngine as JaxEngine
    from mlops_tpu_torch.bundle import load_bundle
    from mlops_tpu_torch.serve.engine import InferenceEngine

    rules = [{"point": "serve.engine.dispatch", "mode": "raise", "after": 1, "max_fires": 1},
             {"point": "serve.engine.dispatch_group", "mode": "raise", "after": 1}]
    engine = InferenceEngine(load_bundle(bundle_dir), buckets=(1, 8), device="cpu")
    got = _dispatches(faults, engine, rules)
    want = _dispatches(jax_faults, JaxEngine(jax_load_bundle(bundle_dir), buckets=(1, 8)),
                       rules)
    assert got == want
    assert got[0] == [None, None, "injected fault at serve.engine.dispatch", None, None,
                      "injected fault at serve.engine.dispatch_group",
                      "injected fault at serve.engine.dispatch_group"]
    # A raised dispatch ran no program.
    assert sum(engine.dispatch_counts().values()) == 3


# ------------------------------------------------------------ torn writes
def _killed(script: str, **env) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), **env))
    assert out.returncode == -9, (out.returncode, out.stderr[-2000:])
    return out


def test_a_reservoir_killed_mid_write_leaves_the_prior_snapshot(tmp_path):
    state = tmp_path / "state"
    rng = np.random.default_rng(0)
    prior = SampleReservoir(64, state)
    prior.add_batch(rng.integers(0, 3, (40, SCHEMA.num_categorical)).astype(np.int32),
                    rng.normal(size=(40, SCHEMA.num_numeric)).astype(np.float32))
    prior.save()
    before = (state / "reservoir.npz").read_bytes()
    _killed(f"""
        import numpy as np
        from mlops_tpu_torch import faults
        from mlops_tpu_torch.lifecycle.retrain import SampleReservoir
        from mlops_tpu_torch.schema.features import SCHEMA
        faults.arm(faults.FaultPlan.from_rules(
            [{{"point": "lifecycle.reservoir.midwrite", "mode": "kill"}}]))
        res = SampleReservoir(64, {str(state)!r})
        res.load()
        res.add_batch(np.ones((9, SCHEMA.num_categorical), np.int32),
                      np.ones((9, SCHEMA.num_numeric), np.float32))
        res.save()
    """)
    assert (state / "reservoir.npz").read_bytes() == before
    jax_res = JaxReservoir(64, str(state))
    assert jax_res.load() and jax_res.rows == 40
    cat, num = jax_res.window()
    want_cat, want_num = prior.window()
    assert np.array_equal(cat, want_cat) and np.array_equal(num, want_num)


def test_an_atomic_write_killed_mid_write_leaves_the_prior_file(tmp_path):
    target = tmp_path / "record.json"
    from mlops_tpu_torch.utils.io import atomic_write

    atomic_write(target, b"GOOD" * 1024)
    _killed(f"""
        from mlops_tpu_torch import faults
        from mlops_tpu_torch.utils.io import atomic_write
        faults.arm(faults.FaultPlan.from_rules(
            [{{"point": "io.atomic_write.midwrite", "mode": "kill"}}]))
        atomic_write({str(target)!r}, b"TORN" * 4096)
    """)
    assert target.read_bytes() == b"GOOD" * 1024


def _fake_nvcc(tmp_path: Path) -> tuple[Path, Path]:
    """An nvcc on ``CUDA_HOME`` that writes a stub library and counts its
    calls."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    count = tmp_path / "nvcc-calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f'echo call >> "{count}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo stub library > "$2"\n')
    nvcc.chmod(0o755)
    return tmp_path / "cuda", count


_BUILD = """
import json
from mlops_tpu_torch import faults
from mlops_tpu_torch.ops import cuda_build
cuda_build.set_cache_dir({cache!r})
{arm}
result = cuda_build.build_shared_library(cuda_build.PACKAGE_DIR / "csrc" / "quant_fused.cu",
                                         "quant_fused")
print(json.dumps([str(result.path), result.reused, cuda_build.cache_discards()]))
"""


def test_a_kernel_build_killed_mid_persist_leaves_no_library(tmp_path):
    cuda_home, count = _fake_nvcc(tmp_path)
    cache = tmp_path / "cache"
    arm = ('faults.arm(faults.FaultPlan.from_rules('
           '[{"point": "compilecache.persist.midwrite", "mode": "kill"}]))')
    _killed(_BUILD.format(cache=str(cache), arm=arm), CUDA_HOME=str(cuda_home))
    kernels = cache / "kernels"
    assert [p for p in kernels.iterdir() if p.name.endswith(".so")
            and ".tmp." not in p.name] == []
    out = subprocess.run([sys.executable, "-c", _BUILD.format(cache=str(cache), arm="")],
                         capture_output=True, text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), CUDA_HOME=str(cuda_home)))
    assert out.returncode == 0, out.stderr
    path, reused, discards = json.loads(out.stdout.strip().splitlines()[-1])
    assert not reused and discards == 0 and Path(path).read_bytes() == b"stub library\n"
    assert count.read_text().count("call") == 2


def test_a_corrupt_cache_read_is_a_counted_discard_and_a_rebuild(tmp_path):
    cuda_home, count = _fake_nvcc(tmp_path)
    cache = tmp_path / "cache"
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_HOME=str(cuda_home))
    arm = ('faults.arm(faults.FaultPlan.from_rules([{"point": "compilecache.read", '
           '"mode": "corrupt", "flip_bits": 8}]))')
    runs = []
    for step in ("", arm, ""):
        out = subprocess.run([sys.executable, "-c", _BUILD.format(cache=str(cache), arm=step)],
                             capture_output=True, text=True, cwd=ROOT, timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    # Built; then the corrupt read discarded it (never loaded) and nvcc
    # rebuilt it; then the healed cache is reused.
    assert [r[1:] for r in runs] == [[False, 0], [False, 1], [True, 0]]
    assert count.read_text().count("call") == 2
    assert Path(runs[2][0]).read_bytes() == b"stub library\n"
    assert (Path(runs[2][0] + ".sha256").read_text().strip()
            == cuda_build._sha256(Path(runs[2][0])))
