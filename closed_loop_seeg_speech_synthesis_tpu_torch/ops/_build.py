"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the repository root (git-ignored),
named by a hash of its source, the headers in ``csrc/`` (``*.cuh``) and the
flags, so an edited source or header rebuilds and an unchanged one is
reused.  A failed build raises; nothing falls back.

Every C entry point takes device pointers, integer sizes and the CUDA
stream, launches on that stream without synchronising, and returns
``cudaGetLastError()``; ``check`` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                       "of this package are built from source at first use")


def digest(name: str, csrc: Path = CSRC) -> str:
    """Hash of ``csrc/<name>.cu``, every header ``csrc/*.cuh`` it may include,
    and the flags: the library's name."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.  The build's seconds and
    the compiler's register/shared-memory report are kept in ``build_info``."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{digest(name)}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        os.replace(tmp, out)
    build_info[name] = {"seconds": time.perf_counter() - t0, "library": out.name, "log": log}
    return ctypes.CDLL(str(out))


build_info: dict = {}


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int, n_float: int = 0):
    """Declare ``fn(ptr * n_ptr, int * n_int, float * n_float, stream) -> int``."""
    f = getattr(lib, fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")
