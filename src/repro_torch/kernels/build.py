"""Build and load the port's CUDA kernels.

`load()` compiles every `csrc/*.cu` source with `nvcc` the first time it
is called, one `nvcc` per source, all started together, links the
objects into one shared library with a plain C interface, and loads it
with `ctypes`.  The library lives in `csrc/build/` (listed in
`.gitignore`), keyed on a hash of every source and header and of the
flags, so an edit rebuilds and an unchanged tree is compiled once per
checkout.  A failed build raises.  Nothing is built or loaded at import
time: machines without `nvcc` import this module freely.
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
SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))
BUILD_DIR = _CSRC / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

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
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES + HEADERS:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"repro_torch_kernels-{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of any that
    fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory, then rename: concurrent builders
    # never see a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in SOURCES]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                  for src, obj in zip(SOURCES, objs)])
        lib = os.path.join(tmp, out.name)
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cut_matvec.argtypes = [p, i, p, i, p, p, p, i, ll, i, ll, p]
    lib.cut_matvec.restype = i
    lib.cut_vecmat.argtypes = [p, i, p, i, p, i, ll, i, ll, p]
    lib.cut_vecmat.restype = i
    lib.cut_rank1.argtypes = [p, i, p, i, p, i, ll, p]
    lib.cut_rank1.restype = i
    lib.cut_matvec_runs.argtypes = [p, i, ll, p, i, ll, p, p, p, i, i, ll,
                                    i, ll, p]
    lib.cut_matvec_runs.restype = i
    lib.cut_vecmat_runs.argtypes = [p, i, ll, p, i, ll, p, ll, i, i, ll, i,
                                    ll, p]
    lib.cut_vecmat_runs.restype = i
    lib.cut_rank1_runs.argtypes = [p, i, ll, p, i, ll, p, i, i, ll, p]
    lib.cut_rank1_runs.restype = i
    f = ctypes.c_float
    lib.fused_cut_round_scratch.argtypes = [i, i]
    lib.fused_cut_round_scratch.restype = ll
    lib.fused_cut_round_occupancy.argtypes = [i, i, ll, i]
    lib.fused_cut_round_occupancy.restype = i
    lib.fused_cut_round.argtypes = [p, i, *([p] * 13), i, ll, i, ll, i, i,
                                    ll, f, f, f, f, p]
    lib.fused_cut_round.restype = i
    lib.fused_cut_round_runs.argtypes = [p, i, *([p] * 14), i, i, ll, i,
                                         ll, i, i, ll, f, f, f, f, p]
    lib.fused_cut_round_runs.restype = i
    for name in ("flash_attention_simt_max_head_dim",
                 "mlstm_chunk_simt_max_head_dim",
                 "mlstm_chunk_simt_max_len"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.flash_attention_simt.argtypes = [p, p, p, p, *([i] * 9), f, p]
    lib.flash_attention_simt.restype = i
    lib.flash_attention_sm90.argtypes = [p, p, p, p, *([i] * 8), f, p]
    lib.flash_attention_sm90.restype = i
    lib.flash_attention_sm90_hd256.argtypes = [p, p, p, p, *([i] * 8), f, p]
    lib.flash_attention_sm90_hd256.restype = i
    lib.mlstm_chunk_simt.argtypes = [*([p] * 12), i, i, i, i, f, p]
    lib.mlstm_chunk_simt.restype = i
    lib.mlstm_chunk_sm90.argtypes = [*([p] * 12), i, i, i, f, p]
    lib.mlstm_chunk_sm90.restype = i
    lib.flash_attention_sm90_f32.argtypes = [p, p, p, p, *([i] * 8), f, p]
    lib.flash_attention_sm90_f32.restype = i
    lib.mlstm_chunk_sm90_f32.argtypes = [*([p] * 12), i, i, i, f, p]
    lib.mlstm_chunk_sm90_f32.restype = i
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
