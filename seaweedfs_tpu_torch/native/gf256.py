"""ctypes binding for the native GF(256) matrix transform (gf256.c).

The native analog of klauspost/reedsolomon's assembly hot loop
(ec_encoder.go:192 call path). Returns None-capable: callers fall back to
the numpy path when the toolchain is unavailable.

A copy of seaweedfs_tpu/native/gf256.py in the PyTorch port.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build

_u8p = ctypes.POINTER(ctypes.c_uint8)


def available() -> bool:
    lib = build.load()
    return lib is not None and hasattr(lib, "swtpu_gf256_transform")


def _as_ptr(a: np.ndarray) -> "ctypes._Pointer":
    return a.ctypes.data_as(_u8p)


def transform(consts: np.ndarray, inputs: list[np.ndarray],
              scalar: bool = False) -> list[np.ndarray]:
    """out[r] = XOR_j gfmul(consts[r,j], inputs[j]) over equal-length
    uint8 arrays. Returns freshly-allocated output arrays."""
    lib = build.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rows, k = consts.shape
    if len(inputs) != k:
        raise ValueError(f"consts is {rows}x{k} but got {len(inputs)} inputs")
    n = len(inputs[0])
    ins = [np.ascontiguousarray(x, dtype=np.uint8) for x in inputs]
    # hard length check: the C kernel reads exactly n bytes from every
    # input, and a short buffer would be a heap over-read (asserts vanish
    # under python -O, so raise)
    if any(len(x) != n for x in ins):
        raise ValueError("input shards have differing lengths")
    outs = [np.empty(n, dtype=np.uint8) for _ in range(rows)]
    c = np.ascontiguousarray(consts, dtype=np.uint8)
    in_ptrs = (_u8p * k)(*[_as_ptr(x) for x in ins])
    out_ptrs = (_u8p * rows)(*[_as_ptr(x) for x in outs])
    fn = (lib.swtpu_gf256_transform_scalar if scalar
          else lib.swtpu_gf256_transform)
    fn(_as_ptr(c), rows, k, in_ptrs, out_ptrs, n)
    return outs
