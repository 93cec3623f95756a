"""Build a kernel source with ``nvcc`` into a shared library, once.

Each ``csrc/*.cu`` file has a plain C entry point, is compiled for
``sm_90a`` at first use into ``_build/`` (git-ignored), keyed by a hash of the
source and the flags, and is loaded with ``ctypes`` by its wrapper. Nothing
is built when a module is imported. Two sources build in parallel when their
wrappers' ``build()`` run in two threads (``subprocess.run`` releases the GIL).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Tuple

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def nvcc_build(source: Path) -> Tuple[Path, float, str]:
    """Compile ``source`` unless its library exists. Returns the library's
    path, the nvcc seconds (0.0 when it was already built) and nvcc's output
    (ptxas -v: registers, shared memory, spills)."""
    src = source.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{source.stem}-{key}.so"
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so, seconds, proc.stdout + proc.stderr
