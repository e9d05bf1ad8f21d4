#!/usr/bin/env python3
"""The SASS instruction mix of each CUDA kernel the port builds.

    python3 scripts/kernel_sass.py [LIB.so ...] > mix.jsonl

With no library named, builds (or reuses) the port's three kernel
sources into ``build/kernels/`` with ``ops/cuda_build.py`` and reads
those. Runs ``cuobjdump -sass`` (the CUDA toolkit's, else the copy that
the ``triton`` package carries under ``triton/backends/nvidia/bin/``;
it fails loudly if neither is found) and prints one JSON line per
kernel function: the static count of each instruction class that bounds
the port's kernels: ``MUFU.EX2`` (exponentials), ``HMMA``/``HGMMA``
(tensor cores: ``mma.sync`` / ``wgmma``), ``FFMA``/``FMUL``/``FADD``/
``FMNMX`` (the softmax's f32 work), ``LDS``/``LDSM`` (operand loads from
shared memory), ``BAR``/``SYNCS`` (CTA barriers / ``mbarrier`` traffic),
``LDG`` (global loads), ``UTMALDG`` (TMA loads), ``SHFL`` (warp
shuffles) and ``LDL``/``STL`` (local memory: arrays or spills that the
registers did not hold), with the f32 and shared-load instructions per
exponential. Counts are of the compiled code, not of executed
instructions: a loop body counts once.

Needs only the toolkit's ``cuobjdump`` and, to build, ``nvcc``: no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

CLASSES = (
    "MUFU.EX2", "HMMA", "HGMMA", "FFMA", "FMUL", "FADD", "FMNMX",
    "LDS", "LDSM", "STS", "BAR", "SYNCS", "LDG", "UTMALDG", "SHFL",
    "LDL", "STL",
)
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
# An instruction line: "/*0123*/   @!P0 OPCODE.MOD ... ;"
_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def find_cuobjdump() -> str:
    """cuobjdump from ``CUDA_HOME`` (or /usr/local/cuda), PATH, or the
    triton package's bundled toolkit binaries."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidates = [Path(home) / "bin" / "cuobjdump"]
    found = shutil.which("cuobjdump")
    if found:
        candidates.append(Path(found))
    try:
        import triton

        candidates.append(
            Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        )
    except ImportError:
        pass
    for path in candidates:
        if path.exists():
            return str(path)
    raise SystemExit(
        "kernel_sass.py: cuobjdump not found ($CUDA_HOME/bin, /usr/local/cuda/bin, "
        "PATH, triton/backends/nvidia/bin): cannot read the SASS"
    )


def demangle(names: list[str]) -> dict[str, str]:
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {n: n for n in names}


def classify(opcode: str) -> str | None:
    """The class an opcode counts under (``MUFU.EX2`` by its modifier,
    the others by the opcode before its first dot)."""
    if opcode.startswith("MUFU.EX2"):
        return "MUFU.EX2"
    base = opcode.split(".", 1)[0]
    return base if base in CLASSES else None


def instruction_mix(sass: str) -> dict[str, dict[str, int]]:
    """Per function in ``cuobjdump -sass`` output: counts by class and the
    total instruction count."""
    mix: dict[str, dict[str, int]] = {}
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = mix.setdefault(m.group(1), {c: 0 for c in CLASSES} | {"total": 0})
            continue
        m = _INSTR.match(line)
        if m and current is not None:
            current["total"] += 1
            cls = classify(m.group(1))
            if cls is not None:
                current[cls] += 1
    return mix


def per_exponential(counts: dict[str, int]) -> dict[str, float] | None:
    ex2 = counts["MUFU.EX2"]
    if not ex2:
        return None
    f32 = sum(counts[c] for c in ("FFMA", "FMUL", "FADD", "FMNMX"))
    return {
        "f32_per_ex2": f32 / ex2,
        "shared_loads_per_ex2": (counts["LDS"] + counts["LDSM"]) / ex2,
        "mma_per_ex2": (counts["HMMA"] + counts["HGMMA"]) / ex2,
        "instructions_per_ex2": counts["total"] / ex2,
    }


def default_libraries() -> list[Path]:
    from mlops_tpu_torch.ops import attention, quant_kernel
    from mlops_tpu_torch.ops.cuda_build import build_shared_library

    sources = {
        "quant_fused": quant_kernel.KERNEL_SOURCE,
        "flash_attention": attention.KERNEL_SOURCE,
        "flash_attention_bwd": attention.BWD_KERNEL_SOURCE,
    }
    return [build_shared_library(src, name).path for name, src in sources.items()]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("libraries", nargs="*", type=Path)
    args = parser.parse_args()
    tool = find_cuobjdump()
    libraries = args.libraries or default_libraries()
    for lib in libraries:
        proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"cuobjdump failed on {lib}:\n{proc.stderr}")
        mix = instruction_mix(proc.stdout)
        if not mix:
            raise SystemExit(f"no kernel functions in the SASS of {lib}")
        names = demangle(list(mix))
        for mangled, counts in sorted(mix.items(), key=lambda kv: names[kv[0]]):
            row = {"library": lib.name, "kernel": names[mangled], **counts,
                   "per_ex2": per_exponential(counts)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
