"""Build the package's CUDA sources with nvcc at first use; load with ctypes.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. ``--use_fast_math`` is
deliberately absent: it would swap ``expf``/``logf``/``sincosf`` for
approximations and break the agreement with the plain PyTorch versions.
The output goes to ``build/kernels/`` at the repository root (listed in
``.gitignore``); a build writes a temporary file and renames it into place,
so concurrent processes never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name → (library, build record); one load per process
_LOADED: Dict[str, Tuple[ctypes.CDLL, dict]] = {}


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to "
                       "build the CUDA kernels")


def load_library(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<name>.cu``. Returns the library
    and a record {"path", "seconds", "built", "log"} of what happened."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    record = {"path": str(lib_path), "seconds": 0.0, "built": False, "log": ""}
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        record["seconds"] = time.perf_counter() - t0
        record["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {src}:\n"
                               f"{' '.join(cmd)}\n{record['log']}")
        os.replace(tmp, lib_path)
        record["built"] = True
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[name] = (lib, record)
    return lib, record
