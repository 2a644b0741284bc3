"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for Hopper (`sm_90a`) into `seaweedfs_tpu_torch/_build/`, then
loaded with ctypes. The library's file name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale
library is never loaded. No PyTorch headers are involved, which keeps a
build to seconds.

Nothing here runs at import time: the wrappers call `load(name)` when
they first launch a kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

# every kernel source of the package, by stem
SOURCES = ("gf256_transform", "gf2_bitmatrix", "crc32c")

# -Xptxas=-v makes the compiler report each kernel's registers, shared
# memory and spills; build_all hands that report back to the caller
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME or /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built on this host")


def library_path(name: str) -> str:
    """Where the library built from the current csrc/<name>.cu lives."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        src = f.read()
    h = hashlib.sha256(src + repr(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def nvcc_command(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC, name + ".cu")]


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every listed source that has no up-to-date library, one
    nvcc process per source, all started together. Returns name -> the
    compiler's output (empty when the library was already built).
    Raises RuntimeError naming each source that failed."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build_all((name,))
            lib = _loaded[name] = ctypes.CDLL(path)
        return lib
