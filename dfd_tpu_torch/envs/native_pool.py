"""ctypes binding for the native (C++) batched trap-env pool, the port's own.

The library steps N ``simple_trap_env`` instances per call across a
``std::thread`` pool.  Its source is the repo's ``runtime/envpool.cc``; the
port builds it at first use with ``g++`` (the flags of
``runtime/build.sh``) into its own build directory,
``build/dfd_tpu_torch/libdfd_envpool-<digest>.so``, named by a digest of the
source and the flags, so an edited source is rebuilt.  An installed port,
which has no ``runtime/``, loads the copy its wheel build put in
``dfd_tpu_torch/_native/`` (setup.py).  It never loads the JAX package's
copies (``runtime/libdfd_envpool.so``, ``dfd_tpu/_native/``).
``DFD_ENVPOOL_LIB`` names a library to load instead.  A failed build
raises, and so does finding no library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from dfd_tpu_torch.envs.trap import load_walkable_grid
from dfd_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "runtime" / "envpool.cc"
NATIVE_DIR = Path(__file__).resolve().parents[1] / "_native"  # an installed port's copy
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdfd_envpool-{digest[:16]}.so"


def build() -> Path:
    """The port's library, compiled first if it does not exist (to a file of
    this process's own, renamed into place, so concurrent builds never see
    half a library)."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def _find_lib() -> str:
    """Search order: ``DFD_ENVPOOL_LIB`` when it names a file; the port's
    build where the checkout's source exists (compiled here if missing); the
    installed copy, ``dfd_tpu_torch/_native/libdfd_envpool.so``."""
    explicit = os.environ.get("DFD_ENVPOOL_LIB")
    if explicit and os.path.exists(explicit):
        return explicit
    if SOURCE.exists():
        return str(build())
    installed = NATIVE_DIR / "libdfd_envpool.so"
    if installed.exists():
        return str(installed)
    raise FileNotFoundError(
        f"no native env pool library: DFD_ENVPOOL_LIB names no file ({explicit!r}), no source "
        f"at {SOURCE} to build, no installed copy at {installed}")


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(_find_lib())
    lib.dfd_trap_pool_create.restype = ctypes.c_void_p
    lib.dfd_trap_pool_create.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dfd_trap_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.dfd_trap_pool_reset_all.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.dfd_trap_pool_step.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.dfd_trap_pool_size.restype = ctypes.c_int
    lib.dfd_trap_pool_size.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_pool_available() -> bool:
    """True once the library loads (building it first); a failed build, or
    no library to load, raises."""
    return _load() is not None


class NativeTrapPool:
    """N lockstep simple_trap_env instances stepped in native code."""

    def __init__(self, n_envs: int, map_path: Optional[str] = None,
                 n_threads: Optional[int] = None):
        lib = _load()
        self._lib = lib
        grid = np.ascontiguousarray(load_walkable_grid(map_path).astype(np.uint8))
        if n_threads is None:
            n_threads = min(os.cpu_count() or 1, 8)
        self.n_envs = n_envs
        self._handle = lib.dfd_trap_pool_create(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), grid.shape[0], grid.shape[1],
            n_envs, n_threads)
        self._obs = np.empty((n_envs, 2), np.float32)
        self._rew = np.empty(n_envs, np.float32)
        self._done = np.empty(n_envs, np.uint8)

    def reset_all(self) -> np.ndarray:
        self._lib.dfd_trap_pool_reset_all(
            self._handle, self._obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return self._obs.copy()

    def step(self, actions: np.ndarray,
             auto_reset: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        a = np.ascontiguousarray(actions, dtype=np.int32)
        self._lib.dfd_trap_pool_step(
            self._handle,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._rew.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._done.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            1 if auto_reset else 0,
        )
        return self._obs.copy(), self._rew.copy(), self._done.astype(bool)

    def close(self) -> None:
        if self._handle:
            self._lib.dfd_trap_pool_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
