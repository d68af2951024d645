"""ctypes bridge to the C++ host runtime (``native/azg_native.cpp``) — the
port's own copy of alphazero_general_tpu/ops/native.py.

The source is the JAX package's, unchanged. It is compiled with g++ on
first use into ``alphazero_general_tpu_torch/_build/`` (listed in
``.gitignore``) under a name that hashes the source and the flags, never
over ``native/libazg_native.so``. The flags leave out ``-march=native``:
a library built on one host may be loaded on another. The build and the
load run under a lock, once per process; a failed build raises
:class:`NativeUnavailable` with the compiler's error, and so does every
later call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR.parent / "native" / "azg_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

GAME_IDS = {"connect4": 0, "tictactoe": 1}
ACTION_SIZES = {"connect4": 7, "tictactoe": 9}
BOARD_SIZES = {"connect4": 42, "tictactoe": 9}

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libazg_native-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:  # no g++ on this host
        raise NativeUnavailable(f"native build failed: {e}") from e
    if proc.returncode != 0:
        raise NativeUnavailable(f"native build failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, lib)  # atomic: another process never loads half a file


def _load():
    """The library, built and bound on first use."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise NativeUnavailable(_build_error)
        try:
            if not SOURCE.is_file():
                raise NativeUnavailable(f"native source missing: {SOURCE}")
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, NativeUnavailable) as e:
            _build_error = str(e)
            raise NativeUnavailable(_build_error) from e
        lib.azg_raw_mcts_solve.restype = ctypes.c_int
        lib.azg_raw_mcts_solve.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int8),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def raw_mcts_solve(game: str, board: np.ndarray, player: int, turns: int,
                   sims: int, cpuct: float = 1.25, fpu_reduction: float = 0.2,
                   min_discount: float = 1.0, seed: int = 0):
    """The native raw MCTS on one position.

    Returns (best_action, counts int32[A], root_value, max_depth).
    """
    lib = _load()
    if game not in GAME_IDS:
        raise NativeUnavailable(f"unknown native game {game!r}")
    flat = np.ascontiguousarray(board, dtype=np.int8).reshape(-1)
    if flat.size != BOARD_SIZES[game]:
        raise ValueError(f"a {game} board has {BOARD_SIZES[game]} cells, "
                         f"got {flat.size}")
    counts = np.zeros(ACTION_SIZES[game], np.int32)
    value = ctypes.c_float(0.0)
    depth = ctypes.c_int32(0)
    best = lib.azg_raw_mcts_solve(
        GAME_IDS[game],
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        int(player), int(turns), int(sims),
        float(cpuct), float(fpu_reduction), float(min_discount),
        int(seed) & 0xFFFFFFFF,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(value), ctypes.byref(depth),
    )
    if best < 0:
        raise NativeUnavailable(f"unknown native game {game!r}")
    return int(best), counts, float(value.value), int(depth.value)
