"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` expose plain C entry points, so they compile with
``nvcc`` alone — no PyTorch headers — in a few seconds each. Every source
compiles in its own ``nvcc`` process, all started together, and the objects
link into one shared library that ``ctypes`` loads. The library lands in
``alphazero_general_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name that hashes the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.

Nothing is built or loaded at import: the first kernel launch calls
:func:`load_library`. That first call may come from any thread (the
evaluator searches on its own), so the build and the load run under one
lock, once per process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false keeps every multiply and add separately rounded, as the plain
# PyTorch versions and the JAX kernels compute them.
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v", "--fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DESCEND = ([_P] * 9 + [_I, _I, _I, _F, _F, _P, _P, _I, _P], _I)
_BACKUP = ([_P] * 8 + [_I] * 5 + [_F, _I, _I, _P], _I)
_CONV = ([_P] * 8 + [_I] * 6 + [_P], _I)
#: C signature of every entry point: (argtypes, restype). The ``_rows``
#: entry points take batch-major [B, N] tree columns, the others
#: game-minor [N, B] ones, with the same arguments.
SIGNATURES = {
    "azg_descend": _DESCEND,
    "azg_descend_rows": _DESCEND,
    "azg_backup": _BACKUP,
    "azg_backup_rows": _BACKUP,
    "azg_conv3x3_int8": _CONV,
}


#: Held by the first build and load; later launches read ``_LIBRARY`` only.
_LOCK = threading.Lock()
_LIBRARY = None


class BuildResult(NamedTuple):
    path: Path
    log: str  # nvcc's output, including the -Xptxas -v resource summary
    seconds: float  # 0.0 when an identical library was already built


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME/bin and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built on this machine")


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libazg_kernels-{h.hexdigest()[:16]}.so"


def build_library() -> BuildResult:
    """Compile every source in parallel and link them into one library,
    once per process, whichever thread asks first."""
    with _LOCK:
        return _build_library()


@functools.lru_cache(maxsize=None)
def _build_library() -> BuildResult:
    lib = library_path()
    if lib.exists():
        return BuildResult(lib, "(already built)", 0.0)
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in _sources()]
        procs = [
            (src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(_sources(), objs)
        ]
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"--- {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builders never see half
    return BuildResult(lib, "\n".join(logs), time.perf_counter() - t0)


def current_stream(device_index: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on a device, as
    an int: the call that ``torch.cuda.current_stream(...).cuda_stream``
    makes, without building a Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with every entry point's C
    signature declared."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LOCK:
            if _LIBRARY is None:
                lib = ctypes.CDLL(str(_build_library().path))
                for name, (argtypes, restype) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
                _LIBRARY = lib
    return _LIBRARY
