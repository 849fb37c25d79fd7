"""Native (C++) host pieces of the port and their build: the shared-memory
batch ring (``src/shm_ring.cc``) and the host batch-prep ops
(``src/host_ops.cc``), own copies of ``dlrover_tpu/native/src``.

The library is built at first use with one ``g++`` call into the
git-ignored ``_build/`` beside this file, written to a private path and
renamed into place (a second process starting cold never loads a
half-written file), and loaded over ctypes (a C API, no Python headers).
It is named ``libdlrover_tpu_torch_native.so``, so one process can load
it beside the JAX package's ``libdlrover_tpu_native.so``.

A build that fails raises (``load_library``): nothing here switches to
another path quietly. The numpy versions of the ops are chosen only by
the caller, with ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdlrover_tpu_torch_native.so")
_SOURCES = ("shm_ring.cc", "host_ops.cc")


def _build() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= newest_src):
        return LIB_PATH
    tmp_path = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-std=c++17", "-O3", "-shared", "-fPIC", "-Wall",
           "-Wextra", *srcs, "-o", tmp_path, "-lpthread", "-lrt"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp_path, LIB_PATH)
    finally:
        if os.path.exists(tmp_path):
            os.unlink(tmp_path)
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """Build (if stale) and load the library; raises RuntimeError with
    the compiler's output when the toolchain is missing or fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(_build())
        except subprocess.CalledProcessError as e:
            raise RuntimeError(
                f"the native library did not build: {e.stderr}") from e
        except OSError as e:
            raise RuntimeError(
                f"the native library did not build or load: {e}") from e
        _declare_signatures(lib)
        _LIB = lib
        return lib


def _declare_signatures(lib: ctypes.CDLL):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.shm_ring_create.restype = ctypes.c_void_p
    lib.shm_ring_create.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64
    ]
    lib.shm_ring_attach.restype = ctypes.c_void_p
    lib.shm_ring_attach.argtypes = [ctypes.c_char_p]
    lib.shm_ring_push.restype = ctypes.c_int
    lib.shm_ring_push.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_uint64, ctypes.c_long
    ]
    lib.shm_ring_pop.restype = ctypes.c_long
    lib.shm_ring_pop.argtypes = [
        ctypes.c_void_p, u8p, ctypes.c_uint64, ctypes.c_long
    ]
    lib.shm_ring_size.restype = ctypes.c_long
    lib.shm_ring_size.argtypes = [ctypes.c_void_p]
    lib.shm_ring_slot_size.restype = ctypes.c_long
    lib.shm_ring_slot_size.argtypes = [ctypes.c_void_p]
    lib.shm_ring_close.restype = None
    lib.shm_ring_close.argtypes = [ctypes.c_void_p]
    lib.shm_ring_free.restype = None
    lib.shm_ring_free.argtypes = [ctypes.c_void_p]

    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pack_sequences.restype = None
    lib.pack_sequences.argtypes = [
        i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p,
    ]
    lib.shuffle_indices.restype = None
    lib.shuffle_indices.argtypes = [i64p, ctypes.c_int64, ctypes.c_uint64]
    lib.shift_labels.restype = None
    lib.shift_labels.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, i32p,
    ]
