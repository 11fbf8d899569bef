"""Text variants of a kernel source, built into libraries of their own and
timed in turns on one card (``flash_variants.py`` and ``xent_kernels.py``
drive them). A variant is ``ops/csrc/<source>.cu`` with text replacements
applied, ``{"name": [[old, new], ...]}``, each ``old`` found exactly once
(an empty list is the source as it is), built with the port's flags under
``build/variants/`` and swapped in for the wrappers' library."""

import ctypes
import pathlib
import subprocess

import torch

from autodist_tpu_torch.ops import _build

OUT = _build.BUILD_DIR / "variants"


def time_ms(fn, reps: int) -> float:
    """CUDA-event ms a call of ``fn`` over ``reps`` calls, after one."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build(source: str, variants: dict, keep, flags=()) -> dict:
    """Each variant of ``source``, built in parallel with the port's flags
    and ``flags``: ``{name: (library, ptxas lines)}``, the lines being every
    serialization warning and, for each kernel whose ptxas line ``keep``
    accepts, its registers, stack and spills."""
    path = _build.SOURCES[source]
    OUT.mkdir(parents=True, exist_ok=True)
    text = path.read_text()
    procs = {}
    for name, patches in variants.items():
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit(f"variant {name}: {old[:60]!r} is not in the source once")
            src = src.replace(old, new)
        cu, lib = OUT / f"{source}_{name}.cu", OUT / f"lib{source}_{name}.so"
        cu.write_text(src)
        procs[name] = lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-I", str(path.parent), "-o",
             str(lib), str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} did not build:\n{log[-3000:]}")
        lines = log.splitlines()
        built[name] = (lib, [line.strip() for line in lines if "serialized" in line]
                       + [f"{line.split('for ', 1)[-1].strip()}: {lines[i + 2].strip()}; "
                          f"{lines[i + 1].strip()}"
                          for i, line in enumerate(lines[:-2])
                          if "Function properties for" in line and keep(line)])
    return built


def load(path: pathlib.Path, lib_fn):
    """The library at ``path`` with the argument types that ``lib_fn`` (a
    wrapper module's cached ``_lib``) gives its own."""
    real = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))
    try:
        return lib_fn.__wrapped__()
    finally:
        _build.load = real


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
