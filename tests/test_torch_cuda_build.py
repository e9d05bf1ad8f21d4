"""mlops_tpu_torch.ops.cuda_build: a library is named by the hash of its
source, the headers beside it and the flags, so editing a shared header
rebuilds every source that includes it (nvcc is replaced by a stub that
writes the output file)."""

import subprocess
from pathlib import Path

import pytest

from mlops_tpu_torch.ops import cuda_build


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"stub")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
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


@pytest.mark.parametrize("edited", ["a.cu", "shared.cuh"])
def test_editing_the_source_or_a_header_beside_it_rebuilds(tmp_path, stub_nvcc, edited):
    src = _sources(tmp_path)
    first = cuda_build.build_shared_library(src / "a.cu", "a")
    (src / edited).write_text((src / edited).read_text() + "// edited\n")
    second = cuda_build.build_shared_library(src / "a.cu", "a")
    assert not second.reused and second.path != first.path
    assert len(stub_nvcc) == 2


def test_the_package_sources_include_only_headers_beside_them():
    csrc = cuda_build.PACKAGE_DIR / "csrc"
    for source in csrc.glob("*.cu"):
        for line in source.read_text().splitlines():
            if line.startswith('#include "'):
                assert (csrc / line.split('"')[1]).exists(), (source, line)
