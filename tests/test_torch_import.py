"""The port stands alone: ``mlops_tpu_torch`` imports neither JAX nor
anything of the JAX package (nor the msgpack package, which the card
machine lacks: the port has its own codec), and its entry points run on
the card unless the caller asks for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "mlops_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "mlops_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_importing_every_submodule_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import mlops_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "mlops_tpu_torch.__path__, 'mlops_tpu_torch.')"
        " if not m.name.endswith('__main__')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps([names, sorted(sys.modules)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "mlops_tpu_torch.serve.server" in names
    assert "mlops_tpu_torch.ops.quant_kernel" in names
    assert "mlops_tpu_torch.train.pipeline" in names
    assert "mlops_tpu_torch.bundle.registry" in names
    for name in ("data.pipeline_exec", "data.stream", "parallel.bulk",
                 "train.distill", "lifecycle.promote", "train.hpo",
                 "replicaset.router", "tenancy.config", "tenancy.quota",
                 "tenancy.router", "tenancy.registry", "trace.span", "trace.recorder",
                 "trace.shapes", "trace.report", "slo.engine", "slo.ledger",
                 "slo.flightrec", "autotune", "autotune.costmodel", "autotune.search",
                 "autotune.apply", "models.gbm", "ops.gbm_tensor"):
        assert f"mlops_tpu_torch.{name}" in names
    assert [m for m in loaded if _forbidden(m)] == []


def test_the_gbm_tier_loads_no_sklearn():
    """The card's machine has neither scikit-learn nor joblib: the gbm
    tier's modules, the engine and the bundle loader import neither (they
    import them inside the functions that need them)."""
    code = (
        "import json, sys\n"
        "import mlops_tpu_torch.ops.gbm_tensor, mlops_tpu_torch.models.gbm\n"
        "import mlops_tpu_torch.serve.engine, mlops_tpu_torch.bundle.bundle\n"
        "import mlops_tpu_torch.parallel.bulk, mlops_tpu_torch.train.pipeline\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('sklearn', 'joblib'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_replica_router_and_the_tenancy_front_half_load_no_torch():
    """What the supervisor and the front ends import of the replica set
    and of tenancy is torch-free; the registry, which builds engines,
    loads lazily."""
    code = (
        "import json, sys\n"
        "import mlops_tpu_torch.replicaset, mlops_tpu_torch.replicaset.router\n"
        "import mlops_tpu_torch.tenancy.config, mlops_tpu_torch.tenancy.quota\n"
        "from mlops_tpu_torch.tenancy import TenantRouter, QuotaGovernor, load_tenants_toml\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'"
        " or m == 'mlops_tpu_torch.tenancy.registry')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_trace_and_slo_load_no_torch():
    """The observability layer is torch-free like the JAX package's
    jax-free ``trace/`` and ``slo/``: the supervisor and the front ends
    import it (the front end's whole request path with it)."""
    code = (
        "import json, sys\n"
        "import mlops_tpu_torch.trace, mlops_tpu_torch.slo\n"
        "import mlops_tpu_torch.trace.report, mlops_tpu_torch.slo.flightrec\n"
        "import mlops_tpu_torch.serve.frontend, mlops_tpu_torch.serve.metrics\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] == 'torch')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_autotuner_and_its_command_load_no_torch(tmp_path):
    """``costmodel.py`` and ``search.py`` are torch-free like ``slo/`` and
    ``trace/``, and so is the offline ``autotune`` command end to end
    (the ledger in, a plan out)."""
    code = (
        "import json, sys\n"
        "import mlops_tpu_torch.autotune.costmodel, mlops_tpu_torch.autotune.search\n"
        "import mlops_tpu_torch.autotune\n"
        "from mlops_tpu_torch.slo import CostLedger\n"
        "from mlops_tpu_torch.cli import main\n"
        f"ledger = CostLedger({str(tmp_path)!r})\n"
        "ledger.observe('bucket_8', 'abc', 3, 8, 0.002)\n"
        "ledger.close()\n"
        f"rc = main(['autotune', 'slo.ledger_dir={tmp_path}'])\n"
        "print(json.dumps([rc, sorted(m for m in sys.modules if m.split('.')[0] == 'torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)
    assert out.returncode == 0, out.stderr
    plan = json.loads(out.stdout.strip().splitlines()[-2])
    rc, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert rc in (0, 3) and plan["buckets"][-1] == 256
    assert loaded == []


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_source_file_imports_jax_or_the_reference_package(path):
    tree = ast.parse((ROOT / path).read_text())
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            imported.append(node.module)
    assert [m for m in imported if _forbidden(m)] == []


def test_engine_needs_the_card_unless_asked_for_the_cpu(tmp_path):
    from mlops_tpu_torch.bundle import load_bundle, save_quant_bundle
    from mlops_tpu_torch.data import Preprocessor, generate_synthetic
    from mlops_tpu_torch.monitor.state import fit_monitor
    from mlops_tpu_torch.ops.quant import init_quant_master, quantize_student
    from mlops_tpu_torch.serve.engine import InferenceEngine

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal needs a card-less one")
    columns, _ = generate_synthetic(400, seed=0)
    prep = Preprocessor.fit(columns)
    monitor = fit_monitor(prep.encode(columns), drift_ref_size=128)
    save_quant_bundle(
        tmp_path, prep, monitor, quantize_student(init_quant_master(0)),
        gates={"passed": True},
    )
    bundle = load_bundle(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(bundle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(bundle, device="cuda")
    engine = InferenceEngine(bundle, buckets=(1, 8), serve_tier="quant", device="cpu")
    records = [{"age": 40.0}, {"sex": "female"}]
    response = engine.predict_records(records)
    assert len(response["predictions"]) == 2
    assert all(0.0 <= p <= 1.0 for p in response["predictions"])
