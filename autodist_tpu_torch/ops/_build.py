"""Build of the port's CUDA sources: ``nvcc`` into shared libraries with a
plain C interface, loaded with ``ctypes``.

Each source under ``ops/csrc/`` becomes ``build/lib<name>-<digest>.so`` at the
checkout's root (``build/`` is git-ignored), compiled for Hopper
(``sm_90a``) at first use. The digest covers the source, the headers beside
it (``*.cuh``, such as ``hopper.cuh``, which the TMA sources include) and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as built. Nothing is compiled at import time: the CPU-only test
machines have no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = {"fused_xent": _CSRC / "fused_xent.cu",
           "flash_attention": _CSRC / "flash_attention.cu",
           "lstm_cell": _CSRC / "lstm_cell.cu"}
# -Xptxas -v: registers, shared memory and spills per kernel, kept in the log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        found = os.path.join(CUDA_HOME, "bin", "nvcc")
    if found is None or not os.path.exists(found):
        raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME); "
                           "the port's kernels are built with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    source = SOURCES[name]
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build every named source that is not built yet, one ``nvcc`` per source,
    all started together. Returns ``{name: library path}``; raises with the
    compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    out = {n: library_path(n) for n in names}
    stale = [n for n in names if not out[n].exists()]
    if not stale:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in stale:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[n].name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def build_log(name: str) -> str:
    """The compiler's output of ``name``'s current build ('' if none is kept)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of source ``name``, building it first if needed."""
    return ctypes.CDLL(str(build([name])[name]))
