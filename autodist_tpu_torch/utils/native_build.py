"""Lazy build-and-load of the port's native C++ host libraries (the port's
copy of ``autodist_tpu/utils/native_build.py``).

``g++`` compiles a source at first use into the checkout's git-ignored
``build/``, beside the CUDA kernels (:mod:`autodist_tpu_torch.ops._build`),
under a name that carries the source's hash, so an edited source rebuilds;
a pid-suffixed temporary and an atomic rename let concurrent builders race
safely. Without a compiler it logs a warning and returns ``None``, and the
caller takes its Python path: the package imports and runs on a host with
no toolchain.
"""

import ctypes
import hashlib
import logging
import os
import subprocess
from typing import Optional, Sequence

from autodist_tpu_torch.ops._build import BUILD_DIR

_log = logging.getLogger("autodist_tpu_torch")


def build_native_lib(src_path: str, name: str,
                     extra_flags: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """Compile ``src_path`` into ``build/lib<name>-<hash>.so`` (once) and load
    it; ``None`` when the toolchain or the directory is unavailable."""
    try:
        with open(src_path, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        lib_path = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
        if not os.path.exists(lib_path):
            tmp = lib_path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp,
                 src_path, *extra_flags],
                check=True, capture_output=True)
            os.replace(tmp, lib_path)
        return ctypes.CDLL(lib_path)
    except Exception as e:  # noqa: BLE001 — no g++, read-only tree: the Python path
        _log.warning("Native %s unavailable (%s); using the Python fallback", name, e)
        return None
