"""mlops_tpu_torch.ops.cuda_build: a library is named by the hash of its
source, the headers beside it and the flags, so editing a shared header
rebuilds every source that includes it (nvcc is replaced by a stub that
writes the output file)."""

import subprocess
import sys
from pathlib import Path

import pytest

from mlops_tpu_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"stub")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    # A cache directory another test set (``warmup --cache-dir``) would win
    # over ``BUILD_DIR`` and share its libraries across the cases.
    monkeypatch.setattr(cuda_build, "_cache_dir", None)
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", run)
    return calls


def _sources(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "shared.cuh"\n')
    (src / "shared.cuh").write_text("// v1\n")
    return src


def test_a_built_library_is_reused(tmp_path, stub_nvcc):
    src = _sources(tmp_path)
    first = cuda_build.build_shared_library(src / "a.cu", "a")
    again = cuda_build.build_shared_library(src / "a.cu", "a")
    assert not first.reused and again.reused
    assert again.path == first.path and len(stub_nvcc) == 1


def _rebuild_case(src, calls, edited):
    first = cuda_build.build_shared_library(src / "a.cu", "a")
    (src / edited).write_text((src / edited).read_text() + "// edited\n")
    second = cuda_build.build_shared_library(src / "a.cu", "a")
    assert not second.reused and second.path != first.path
    assert len(calls) == 2


@pytest.mark.parametrize("edited", ["a.cu", "shared.cuh"])
def test_editing_the_source_or_a_header_beside_it_rebuilds(tmp_path, stub_nvcc, edited):
    _rebuild_case(_sources(tmp_path), stub_nvcc, edited)


def test_an_in_process_warmup_leaves_the_rebuild_cases_alone(tmp_path, stub_nvcc,
                                                            monkeypatch):
    """The gbm suite's in-process ``warmup --cache-dir`` and then both
    rebuild cases, in one process in that order: the command hands the
    cache directory back, so each case builds into its own directory (its
    ``BUILD_DIR``, as the fixture gives each case alone)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from torch_gbm_fixture import fixture_bundle
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    from mlops_tpu_torch.cli import main

    bundle = fixture_bundle(tmp_path / "gbm")
    assert main(["warmup", "--cache-dir", str(tmp_path / "cache"),
                 f"serve.model_directory={bundle}"]) == 0
    assert cuda_build.cache_dir() is None
    for edited in ("a.cu", "shared.cuh"):
        case = tmp_path / edited
        case.mkdir()
        monkeypatch.setattr(cuda_build, "BUILD_DIR", case / "kernels")
        stub_nvcc.clear()
        _rebuild_case(_sources(case), stub_nvcc, edited)


def test_the_package_sources_include_only_headers_beside_them():
    csrc = cuda_build.PACKAGE_DIR / "csrc"
    for source in csrc.glob("*.cu"):
        for line in source.read_text().splitlines():
            if line.startswith('#include "'):
                assert (csrc / line.split('"')[1]).exists(), (source, line)
