"""The warm start (``compilecache/``, ``warmup --cache-dir``) and the
kernel cache of ``ops/cuda_build.py``, on the CPU with nvcc replaced as
in ``test_torch_cuda_build.py`` (a stub that writes the output file):

- ``warmup`` fills ``cache.dir`` with what the resolved bundle's serving
  programs launch (every library without a bundle, said on stderr), a
  second run reuses all of it, and ``cache.warmup_workers`` bounds the
  parallel builds;
- a process on a filled cache calls nvcc zero times: ``find_nvcc`` raises;
- a truncated or corrupted library, or one without its sha256, is
  rebuilt, never loaded;
- the CLI prints the report, with an nvcc on ``CUDA_HOME`` that counts
  its calls.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

from mlops_tpu_torch.commands import warmup
from mlops_tpu_torch.compilecache import bundle_libraries, libraries
from mlops_tpu_torch.config import load_config
from mlops_tpu_torch.ops import attention, cuda_build, quant_kernel
from torch_ring import ROOT, budget  # noqa: F401


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """nvcc replaced by a stub that writes its output file (and counts
    how many builds run at once); the kernel cache reset afterwards."""
    calls, live, peak = [], [0], [0]
    lock = threading.Lock()

    def run(cmd, **kwargs):
        with lock:
            calls.append(cmd)
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.05)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"stub library of " + cmd[-1].encode())
        with lock:
            live[0] -= 1
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "default-kernels")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", run)
    yield calls, peak
    cuda_build.set_cache_dir(None)


def _config(cache, bundle="", *overrides):
    return load_config([f"cache.dir={cache}", f"serve.model_directory={bundle or 'nowhere'}",
                        *overrides], env={})


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    from torch_ring import make_bundle

    return make_bundle(tmp_path_factory.mktemp("warmup"))


def test_every_kernel_source_has_one_library():
    by_name = libraries()
    assert by_name["quant_fused"] is quant_kernel._LIBRARY
    assert by_name["flash_attention"] is attention._LIBRARY
    assert by_name["flash_attention_bwd"] is attention._BWD_LIBRARY
    assert sorted(lib.source.name for lib in by_name.values()) == sorted(
        p.name for p in (cuda_build.PACKAGE_DIR / "csrc").glob("*.cu"))


def test_a_bundle_needs_the_libraries_its_tiers_launch(bundle_dir):
    from mlops_tpu_torch.bundle import load_bundle

    bundle = load_bundle(bundle_dir)  # exact tier + a gated quant student
    assert bundle_libraries(bundle, "exact", False) == []
    assert bundle_libraries(bundle, "exact", True) == ["quant_fused"]
    assert bundle_libraries(bundle, "quant", False) == ["quant_fused"]
    assert bundle_libraries(bundle, "auto", False) == ["quant_fused"]
    bundle.manifest["quant"]["gates"]["passed"] = False
    assert bundle_libraries(bundle, "auto", True) == []
    bundle.manifest["flavor"] = "doc"
    assert bundle_libraries(bundle, "exact", False) == ["flash_attention"]


def test_warmup_fills_the_cache_and_a_second_run_reuses_it(
        stub_nvcc, tmp_path, bundle_dir, capsys):
    calls, _ = stub_nvcc
    cache = tmp_path / "cache"
    report = warmup(_config(cache, bundle_dir, "serve.tier_routing=true"))
    assert report["bundle"] == str(bundle_dir)
    assert [row["name"] for row in report["libraries"]] == ["quant_fused"]
    assert report["built"] == 1 and report["nvcc_calls"] == 1 == len(calls)
    path = cache / "kernels" / os.path.basename(report["libraries"][0]["path"])
    assert path.exists() and path.with_name(path.name + ".sha256").exists()
    again = warmup(_config(cache, bundle_dir, "serve.tier_routing=true"))
    assert again["reused"] == 1 and again["nvcc_calls"] == 0 and len(calls) == 1
    # Without a bundle: every library, and stderr says so.
    report = warmup(_config(cache))
    assert report["bundle"] is None
    assert [row["name"] for row in report["libraries"]] == list(libraries())
    assert report["reused"] == 1 and report["built"] == 2
    assert "warmup: no bundle at 'nowhere'" in capsys.readouterr().err
    with pytest.raises(SystemExit, match="--cache-dir"):
        warmup(load_config([], env={}))


@pytest.mark.parametrize("workers,peak", [(0, 1), (2, 2)])
def test_warmup_workers_bound_the_parallel_builds(stub_nvcc, tmp_path, workers, peak):
    calls, seen = stub_nvcc
    report = warmup(_config(tmp_path / "cache", "", f"cache.warmup_workers={workers}"))
    assert report["built"] == 3 and len(calls) == 3
    assert seen[0] == peak


def test_a_process_on_a_filled_cache_calls_nvcc_zero_times(stub_nvcc, tmp_path, monkeypatch):
    """The engine process's warm start: with ``cache.dir`` filled, every
    library the package loads resolves there; nvcc is never looked for."""
    warmup(_config(tmp_path / "cache"))

    def no_nvcc():
        raise AssertionError("nvcc was looked for on a filled cache")

    monkeypatch.setattr(cuda_build, "find_nvcc", no_nvcc)
    calls_before = cuda_build.nvcc_calls()
    cuda_build.set_cache_dir(tmp_path / "cache")
    for library in (quant_kernel._LIBRARY, attention._LIBRARY, attention._BWD_LIBRARY):
        result = library.build()
        assert result.reused and result.path.parent == tmp_path / "cache" / "kernels"
    assert cuda_build.nvcc_calls() == calls_before


@pytest.mark.parametrize("damage", ["truncated", "corrupted", "no checksum"])
def test_a_damaged_library_is_rebuilt_not_loaded(stub_nvcc, tmp_path, damage):
    calls, _ = stub_nvcc
    cuda_build.set_cache_dir(tmp_path / "cache")
    first = quant_kernel._LIBRARY.build()
    good = first.path.read_bytes()
    checksum = first.path.with_name(first.path.name + ".sha256")
    if damage == "truncated":
        first.path.write_bytes(good[:5])
    elif damage == "corrupted":
        first.path.write_bytes(bytes(b ^ 0xFF for b in good))
    else:
        checksum.unlink()
    again = quant_kernel._LIBRARY.build()
    assert not again.reused and len(calls) == 2
    assert again.path.read_bytes() == good
    assert quant_kernel._LIBRARY.build().reused and len(calls) == 2


def test_the_warmup_cli_prints_its_report(tmp_path):
    """``python -m mlops_tpu_torch warmup --cache-dir`` with an nvcc on
    ``CUDA_HOME`` that writes its output and counts its calls: three
    builds, then none."""
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    count = tmp_path / "nvcc-calls"
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo call >> "{count}"\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'echo stub > "$2"\n'
    )
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_HOME=str(tmp_path / "cuda"))
    env.pop("MODEL_DIRECTORY", None)
    cmd = [sys.executable, "-m", "mlops_tpu_torch", "warmup", "--cache-dir",
           str(tmp_path / "cache"), "serve.model_directory=nowhere",
           f"registry.root={tmp_path / 'registry'}", "cache.warmup_workers=3"]
    reports = []
    for _ in range(2):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=tmp_path,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        reports.append(json.loads(out.stdout.strip().splitlines()[-1]))
    assert [r["built"] for r in reports] == [3, 0]
    assert [r["nvcc_calls"] for r in reports] == [3, 0]
    assert len(count.read_text().split()) == 3
    assert reports[1]["cache_dir"] == str(tmp_path / "cache" / "kernels")
