"""Build-on-first-use for the native host library.

The reference gets its host-side speed from amd64 assembly inside Go deps
(klauspost/crc32, klauspost/reedsolomon); the host-side native surface
here is a small C library compiled locally with g++. No network, no pip.

The library is the port's own: it is built from the sources beside this
file into seaweedfs_tpu_torch/_build/, under a name that carries a hash
of those sources and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built at import time: the
first caller of load() builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_SOURCES = [os.path.join(_DIR, "crc32c.c"),
            os.path.join(_DIR, "needle_map.c"),
            os.path.join(_DIR, "gf256.c"),
            os.path.join(_DIR, "stage.c")]
# no -mavx2 etc: SIMD paths use per-function target attributes +
# __builtin_cpu_supports runtime dispatch, so a built library stays safe
# on a different host
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> str:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(repr(_FLAGS).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libswtpu_native-{h.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, *_SOURCES], check=True,
                       capture_output=True, cwd=_DIR, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load() -> ctypes.CDLL | None:
    """Return the native library, building it if needed; None if unavailable."""
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.swtpu_crc32c.restype = ctypes.c_uint32
            lib.swtpu_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                         ctypes.c_size_t]
            u8p = ctypes.POINTER(ctypes.c_uint8)
            for fname in ("swtpu_gf256_transform",
                          "swtpu_gf256_transform_scalar"):
                fn = getattr(lib, fname)
                fn.restype = None
                fn.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(u8p), ctypes.POINTER(u8p),
                               ctypes.c_size_t]
            # build the GF tables now, single-threaded under _lock: the
            # transforms run GIL-free and must never race a lazy init
            lib.swtpu_gf256_init.restype = None
            lib.swtpu_gf256_init()
            u64p = ctypes.POINTER(ctypes.c_uint64)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            lib.swtpu_nm_new.restype = ctypes.c_void_p
            lib.swtpu_nm_free.argtypes = [ctypes.c_void_p]
            lib.swtpu_nm_set.restype = ctypes.c_int
            lib.swtpu_nm_set.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_uint32, ctypes.c_uint32,
                                         u32p, u32p]
            lib.swtpu_nm_get.restype = ctypes.c_int
            lib.swtpu_nm_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                         u32p, u32p]
            lib.swtpu_nm_len.restype = ctypes.c_uint64
            lib.swtpu_nm_len.argtypes = [ctypes.c_void_p]
            lib.swtpu_stage_pieces.restype = None
            lib.swtpu_stage_pieces.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                ctypes.c_void_p]
            lib.swtpu_nm_scan.restype = ctypes.c_uint64
            lib.swtpu_nm_scan.argtypes = [ctypes.c_void_p, u64p, u64p,
                                          u32p, u32p, ctypes.c_uint64]
            _lib = lib
        except Exception:
            _failed = True
        return _lib


def loaded() -> bool:
    """Whether this process has loaded the library (the isolation test
    checks that importing the port does not)."""
    return _lib is not None
