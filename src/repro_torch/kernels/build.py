"""Build and load the port's CUDA kernels.

`load()` compiles `csrc/cut_kernels.cu` with `nvcc` into a shared
library with a plain C interface the first time it is called, and loads
it with `ctypes`.  The output lives in `csrc/build/` (listed in
`.gitignore`), keyed on a hash of the source and the flags, so an edit
rebuilds and an unchanged source is compiled once per checkout.  Nothing
is built or loaded at import time: machines without `nvcc` import this
module freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = _CSRC / "cut_kernels.cu"
BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc on the machine with the card")


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"cut_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never
    # see a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cut_matvec_chunk_cols.argtypes = []
    lib.cut_matvec_chunk_cols.restype = i
    lib.cut_matvec.argtypes = [p, i, p, i, p, p, i, ll, p]
    lib.cut_matvec.restype = i
    for name in ("cut_vecmat", "cut_rank1"):
        fn = getattr(lib, name)
        fn.argtypes = [p, i, p, i, p, i, ll, p]
        fn.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _compile(out)
            _lib = _bind(ctypes.CDLL(str(out)))
        return _lib
