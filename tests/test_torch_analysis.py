"""The port's tpulint (``mlops_tpu_torch/analysis/``) against the JAX
package's, on the CPU.

The planted fixtures of ``tests/fixtures/tpulint/`` go through both
packages' layers 1, 3, 4 and 5 and must give equal (file, line, rule)
sets. Layer 1's PyTorch rules have fixtures of their own under
``tests/fixtures/torch_tpulint/`` (every ``# PLANT:`` fires at its line,
nothing else fires). Layer 2 traces the port's registered programs on
fake tensors clean, with every launch counter unchanged, and each of its
rules fires on a planted program. The gate over the package exits 0 in a
subprocess, and its ``--no-trace`` form imports neither torch nor jax.
The runtime sanitizers (``lockcheck``, ``loopcheck``) run one
scripted workload in both packages and report the same violations and
labels (durations are not compared).
"""

import asyncio
import json
import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

import mlops_tpu.analysis as jax_analysis
import mlops_tpu_torch.analysis as port_analysis
from mlops_tpu.analysis import lockcheck as jax_lockcheck
from mlops_tpu.analysis import loopcheck as jax_loopcheck
from mlops_tpu.analysis.asyncdiscipline import analyze_async_paths as jax_async
from mlops_tpu.analysis.concurrency import analyze_concurrency_paths as jax_concurrency
from mlops_tpu.analysis.contracts import analyze_contracts_paths as jax_contracts
from mlops_tpu_torch.analysis import lockcheck, loopcheck
from mlops_tpu_torch.analysis.astrules import (
    RULES,
    UNMAPPED_RULES,
    analyze_source,
    package_manifests,
)
from mlops_tpu_torch.analysis.asyncdiscipline import analyze_async_paths
from mlops_tpu_torch.analysis.concurrency import analyze_concurrency_paths
from mlops_tpu_torch.analysis.contracts import analyze_contracts_paths
from mlops_tpu_torch.analysis.traces import (
    TRACE_RULES,
    EntryPoint,
    ShardingLink,
    run_trace_checks,
)

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures" / "tpulint"
TORCH_FIXTURES = ROOT / "tests" / "fixtures" / "torch_tpulint"
PACKAGE = ROOT / "mlops_tpu_torch"
_PLANT = re.compile(r"#\s*PLANT:\s*(TPU\d+)")


def _planted(path: Path) -> set[tuple[int, str]]:
    return {(i, m.group(1)) for i, line in enumerate(path.read_text().splitlines(), 1)
            if (m := _PLANT.search(line))}


def _findings(layers, paths) -> set[tuple[str, int, str]]:
    return {(Path(f.path).name, f.line, f.rule) for layer in layers for f in layer(paths)}


# ------------------------------------------------------------ fixture parity
@pytest.mark.parametrize("item", [
    "concurrency", "contracts", "asyncio", "serve", "broad_except.py",
    "mutable_default.py", "suppressed.py", "clean.py",
])
def test_the_planted_fixtures_give_the_jax_analyzers_findings(item):
    paths = [str(FIXTURES / item)]
    jax = _findings((jax_analysis.analyze_paths, jax_concurrency, jax_contracts, jax_async),
                    paths)
    port = _findings((port_analysis.analyze_paths, analyze_concurrency_paths,
                      analyze_contracts_paths, analyze_async_paths), paths)
    assert port == jax
    planted = {(p.name, line, rule) for p in (FIXTURES / item).parent.glob(
        f"{item}/**/*.py" if (FIXTURES / item).is_dir() else item)
        for line, rule in _planted(p)}
    assert planted <= port


# ------------------------------------------------------- Layer 1, PyTorch
@pytest.mark.parametrize("name", ["captured", "serve/unrouted", "clean"])
def test_each_torch_rule_fires_at_its_planted_line_and_nowhere_else(name):
    path = TORCH_FIXTURES / f"{name}.py"
    found = {(f.line, f.rule) for f in analyze_source(path.read_text(), path)}
    assert found == _planted(path)


def test_a_device_wait_under_a_lock_is_blocking():
    path = TORCH_FIXTURES / "sync_under_lock.py"
    found = {(f.line, f.rule) for f in analyze_concurrency_paths([str(path)])}
    assert found == _planted(path)


def test_every_port_rule_has_a_fixture_and_every_dropped_jax_rule_a_reason():
    planted = {rule for p in TORCH_FIXTURES.rglob("*.py") for _, rule in _planted(p)}
    planted |= {rule for p in FIXTURES.rglob("*.py") for _, rule in _planted(p)}
    assert set(RULES) <= planted
    from mlops_tpu.analysis.traces import TRACE_RULES as JAX_TRACE_RULES

    assert set(RULES) | {"TPU105"} == set(jax_analysis.RULES)
    assert set(TRACE_RULES) | {"TPU302"} == set(JAX_TRACE_RULES)
    assert set(UNMAPPED_RULES) == {"TPU105", "TPU302"}
    assert all(len(why) > 40 for why in UNMAPPED_RULES.values())


def test_the_capture_manifest_names_real_factories():
    captured, routed = package_manifests()
    assert len(captured) == 8 and "make_chunk_scorer" in routed
    for entry in captured:
        path, name = entry.split("::")
        assert re.search(rf"^def {name}\(", (PACKAGE / path).read_text(), re.M), entry


def test_a_sync_planted_in_a_captured_program_of_the_package_is_caught():
    """The package's own manifest reaches the package's files: a
    ``.item()`` inside ``make_packed_predict_base``'s program fires."""
    source = (PACKAGE / "ops" / "predict.py").read_text()
    planted = source.replace(
        "        flags = outlier_flags(monitor, numeric, mask)\n",
        "        flags = outlier_flags(monitor, numeric, mask)\n        n = mask.sum().item()\n",
        1)
    found = analyze_source(planted, "mlops_tpu_torch/ops/predict.py",
                           rel_path="mlops_tpu_torch/ops/predict.py")
    assert [f.rule for f in found] == ["TPU101"]
    assert analyze_source(source, "x", rel_path="mlops_tpu_torch/ops/predict.py") == []


# ----------------------------------------------------------------- Layer 2
def _entry(name, fn, buckets, **kw):
    def build(device):
        return fn, {b: (torch.zeros((b, 4), device=device),) for b in buckets}

    return EntryPoint(name=name, build=build, **kw)


def _polymorphic(x):
    return x.sum() if x.shape[0] > 8 else x.mean()


def _broken(x):
    raise RuntimeError("planted")


@pytest.mark.parametrize("rule,entry,links", [
    ("TPU301", _entry("f64", lambda x: x.double().sum(), (1,)), []),
    ("TPU303", _entry("cast", lambda x: x.half().float() + 1, (1,)), []),
    ("TPU304", _entry("poly", _polymorphic, (1, 64)), []),
    ("TPU304", _entry("undeclared", lambda x: x + 1, (1, 8), bucket_families=((1,),)), []),
    ("TPU305", _entry("producer", lambda x: x + 1, (1,), params_out_spec={"w": ("model",)}),
     [ShardingLink("producer", "producer")]),
    ("TPU306", _entry("broken", _broken, (1,)), []),
])
def test_each_trace_rule_fires_on_a_planted_program(rule, entry, links):
    findings, _ = run_trace_checks(entries=[entry], links=links)
    assert {f.rule for f in findings} == {rule}, [f.format() for f in findings]


def test_a_declared_f64_entry_and_shard_at_load_links_pass():
    entry = _entry("x64", lambda x: x.double().float().double().sum(), (1,), x64=True)
    dense = _entry("dense", lambda x: x + 1, (1,))
    consumer = _entry("consumer", lambda x: x + 1, (1,), params_in_spec={"w": ("model",)})
    findings, _ = run_trace_checks(
        entries=[entry, dense, consumer],
        links=[ShardingLink("dense", "consumer", transport="shard-at-load")])
    assert findings == []


# --------------------------------------------------------------- the gate
def test_the_gate_exits_zero_over_the_package_and_traces_every_program():
    out = subprocess.run(
        [sys.executable, "-m", "mlops_tpu_torch", "analyze", "--strict", "--concurrency",
         "--contracts", "--async", "--fail-stale", "mlops_tpu_torch/"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "tpulint: 0 finding(s), 0 gating (strict) over 1 path(s)" in out.stdout
    # Layer 2: every registered program traced on fake tensors, the TP
    # step skipped without a process group, no launch counter moved.
    traced = [line for line in out.stdout.splitlines() if line.startswith("tpulint: traced ")]
    assert len(traced) == 8 and all("no device code executed" in line for line in traced)
    assert "tpulint: skipped train-step-tp" in out.stdout
    assert "tpulint: launch counters unchanged" in out.stdout


@pytest.mark.parametrize("argv,code", [
    (["--no-trace", "--concurrency", "--contracts", "--async", "tests/fixtures/tpulint"], 1),
    (["--no-trace", "tests/fixtures/torch_tpulint/clean.py"], 0),
    (["--no-trace", "no/such/path"], 2),
])
def test_the_exit_codes_are_the_jax_gate_s(argv, code, monkeypatch):
    from mlops_tpu_torch.cli import main

    monkeypatch.chdir(ROOT)
    assert main(["analyze", *argv]) == code



@pytest.mark.parametrize("planted", [False, True], ids=["clean", "nan-weight"])
def test_the_numeric_audit_is_clean_and_a_planted_nan_is_tpu307(planted, monkeypatch, capsys):
    """``--numeric`` runs the exact tier's packed programs under
    ``checked`` where the CLI finds them a device (the CPU here): clean
    on the registered model; with a NaN planted in one weight, the TPU307
    finding naming the entry, and exit 1."""
    import mlops_tpu_torch.models as models
    from mlops_tpu_torch.cli import main

    if planted:
        init_params = models.init_params

        def poisoned(model, seed):
            model = init_params(model, seed)
            with torch.no_grad():
                next(model.parameters()).view(-1)[0] = float("nan")
            return model

        monkeypatch.setattr(models, "init_params", poisoned)
    monkeypatch.chdir(ROOT)
    code = main(["analyze", "--no-trace", "--numeric", "tests/fixtures/torch_tpulint/clean.py"])
    out = capsys.readouterr().out
    if planted:
        assert code == 1, out
        assert "TPU307" in out and "<numeric:serve-predict-packed>" in out
    else:
        assert code == 0, out
        audit = [line for line in out.splitlines() if line.startswith("tpulint: numeric audit")]
        assert len(audit) == 2 and all(
            "numeric audit on cpu:" in line and "clean" in line for line in audit), out

def test_every_package_suppression_is_live_and_counted():
    from mlops_tpu_torch.analysis.suppressions import audit_paths

    suppressions = audit_paths([str(PACKAGE)])
    assert all(s.live for s in suppressions), [s.describe() for s in suppressions if not s.live]
    counts: dict[str, int] = {}
    for s in suppressions:
        for rule in s.rules:
            counts[rule] = counts.get(rule, 0) + 1
    assert counts == {"TPU201": 32, "TPU405": 3, "TPU402": 1, "TPU502": 3}


# ------------------------------------------------------ runtime sanitizers
def _lock_script(module):
    """One scripted workload: an inversion, an undeclared lock nested
    under a declared one, a permit handed across threads."""
    san = module.LockSanitizer(order=("a", "b", "sem"))
    a = san.wrap(threading.Lock(), "a")
    b = san.wrap(threading.Lock(), "b")
    rogue = san.wrap(threading.Lock(), "rogue")
    sem = san.wrap(threading.Semaphore(2), "sem")
    with a, b:
        pass
    with b, a:
        pass
    with a, rogue:
        pass
    sem.acquire()
    t = threading.Thread(target=sem.release)
    t.start()
    t.join()
    with a:
        pass
    return [str(v) for v in san.violations], dict(san.acquired)


def test_the_lock_sanitizer_reports_as_the_jax_one():
    port = _lock_script(lockcheck)
    assert port == _lock_script(jax_lockcheck)
    assert len(port[0]) == 2 and port[1] == {"a": 4, "b": 2, "rogue": 1, "sem": 1}


def _loop_script(module):
    async def stall():
        time.sleep(0.03)  # the bug class under test: a blocking call

    async def quick():
        await asyncio.sleep(0)

    async def main():
        loop = asyncio.get_running_loop()
        with module.instrument_loop(loop, slow_ms=10.0, perturb_seed=7) as san:
            await asyncio.gather(asyncio.create_task(stall()), quick())
        return san

    san = asyncio.run(main())
    return sorted({r.label for r in san.slow}), san


def test_the_loop_sanitizer_reports_as_the_jax_one():
    port_labels, port = _loop_script(loopcheck)
    jax_labels, jax = _loop_script(jax_loopcheck)
    assert port_labels == jax_labels and any("stall" in label for label in port_labels)
    assert port.max_lag_ms >= 25.0 and jax.max_lag_ms >= 25.0
    assert port.snapshot_ms() >= 25.0 and port.snapshot_ms() == 0.0  # window resets
    with pytest.raises(AssertionError, match="event-loop lag"):
        port.assert_max_lag(10.0)


def test_the_no_trace_gate_imports_neither_torch_nor_jax():
    code = (
        "import json, sys\n"
        "from mlops_tpu_torch.cli import main\n"
        "rc = main(['analyze', '--strict', '--no-trace', '--concurrency', '--contracts',"
        " '--async', '--fail-stale', 'mlops_tpu_torch/'])\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'mlops_tpu'))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [0, []]
