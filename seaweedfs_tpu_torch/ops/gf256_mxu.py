"""The GF(256) shard transform as a GF(2) bit-matrix product on Hopper's
int8 tensor cores: the wrapper of the fused CUDA kernel, and its plain
PyTorch version.

`gf2_bitmatrix_transform(bitmat, x)` computes what `gf256_transform`
computes (kernel K1): for a (rows, k) GF(256) coefficient matrix C, given
as its (8 rows, 8 k) int8 GF(2) bit-matrix M = gf.gf2_matrix(C)
(`device_bitmatrix`), and a (B, k, L) uint8 block, the (B, rows, L) result

    out[b, r, :] = XOR_i gf_mul(C[r, i], x[b, i, :])

as out_bits = M x in_bits (mod 2), one byte column at a time. On the card
one kernel (csrc/gf2_bitmatrix.cu) does all of it: it unpacks each
column's k input bytes into int8 tensor-core fragments in registers,
multiplies them by M's transpose with wgmma, and packs the low bits of
the int32 sums into the `rows` output bytes in its epilogue. It reads x
once and writes the output once; the planes and sums never reach device
memory, so the call needs no chunking. See the source's header for the
design and what bounds it.

It is the port of seaweedfs_tpu/ops/gf256_mxu.py (kernel K4:
`_plane_matrix` :33, `_mxu_block` :62, `mxu_words_transform` :86), which
the reference's pipeline reaches under SWTPU_EC_METHOD=mxu; the port's
pipeline reaches this module under SWTPU_TORCH_EC_METHOD=mxu. The
reference multiplies a (32 rows, 32 k) matrix over the 32 bitplanes of
each uint32 word; that matrix is M repeated on the diagonal of the word's
4 byte slots, so the port works per byte and does a quarter of the
reference's products.

The plain version materialises the planes and sums of N columns,
N (8 k + 32 rows) bytes, 30 times the block's own bytes at k = 10,
rows = 4, so it cuts the block into `chunks` of at most `chunk_bytes` of
both together (the same trap as the TPU program's 2048-word-row chunks).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU
tensor it runs the plain version, `gf2_bitmatrix_transform_reference`.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..ec import gf
from . import _build
from .gf256_cuda import check_out

MAX_ROWS = 16
MAX_K = 16

# planes plus int32 sums of one chunk of the plain version, at most
CHUNK_BYTES = 256 << 20

# what gf2_bitmatrix_transform launched on the card, which chip_smoke.py
# reads to show which path went through K4: `launches` counts kernel
# launches (one a call), `calls` counts transforms; raised under a lock,
# since a volume server launches from several executor threads
launches = 0
calls = 0
_count_lock = threading.Lock()


def count_launch() -> None:
    """Add one to `launches` under the lock."""
    global launches
    with _count_lock:
        launches += 1


def count_call() -> None:
    """Add one to `calls` under the lock."""
    global calls
    with _count_lock:
        calls += 1


@functools.cache
def _kernel():
    lib = _build.load("gf2_bitmatrix")
    fn = lib.swtpu_gf2_transform
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def _device_bitmatrix(coeff_key: bytes, rows: int, k: int,
                      device: torch.device) -> torch.Tensor:
    coeff = np.frombuffer(coeff_key, dtype=np.uint8).reshape(rows, k)
    return torch.from_numpy(gf.gf2_matrix(coeff).astype(np.int8)).to(device)


def device_bitmatrix(coeff: np.ndarray, device: torch.device
                     ) -> torch.Tensor:
    """The (8 rows, 8 k) int8 GF(2) bit-matrix of a (rows, k) GF(256)
    matrix, on `device` (cached per matrix; read-only)."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    rows, k = coeff.shape
    return _device_bitmatrix(coeff.tobytes(), rows, k, torch.device(device))


def _check(bitmat: torch.Tensor, x: torch.Tensor) -> None:
    if not isinstance(bitmat, torch.Tensor) or not isinstance(x,
                                                              torch.Tensor):
        raise TypeError("gf2_bitmatrix_transform takes torch tensors")
    if bitmat.dtype != torch.int8 or x.dtype != torch.uint8:
        raise TypeError(f"gf2_bitmatrix_transform takes an int8 bit-matrix "
                        f"and uint8 x, got {bitmat.dtype} and {x.dtype}")
    if bitmat.dim() != 2 or bitmat.shape[0] % 8 or bitmat.shape[1] % 8:
        raise ValueError(f"the bit-matrix must be (8 rows, 8 k), got "
                         f"{tuple(bitmat.shape)}")
    rows, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    if not (1 <= rows <= MAX_ROWS and 1 <= k <= MAX_K):
        raise ValueError(f"the kernel takes 1..{MAX_ROWS} rows and "
                         f"1..{MAX_K} inputs, got rows={rows} k={k}")
    if x.dim() != 3 or x.shape[1] != k:
        raise ValueError(f"x must be (B, {k}, L), got {tuple(x.shape)}")
    if x.device != bitmat.device:
        raise ValueError(f"bit-matrix on {bitmat.device}, x on {x.device}")


def chunks(bsz: int, length: int, k: int, rows: int,
           chunk_bytes: int = CHUNK_BYTES):
    """Yield (b0, nb, l0, lc): windows b0 .. b0+nb-1, columns l0 .. l0+lc-1,
    covering a (bsz, k, length) block in pieces whose planes and sums, as
    the plain version materialises them, take at most chunk_bytes (at least 16 columns a piece): whole block, else
    whole windows, else 16-aligned column ranges of one window."""
    per_col = 8 * k + 32 * rows
    cols = max(16, chunk_bytes // per_col)
    if bsz * length <= cols:
        yield 0, bsz, 0, length
    elif length <= cols:
        step = cols // length
        for b0 in range(0, bsz, step):
            yield b0, min(step, bsz - b0), 0, length
    else:
        step = cols // 16 * 16
        for b0 in range(bsz):
            for l0 in range(0, length, step):
                yield b0, 1, l0, min(step, length - l0)


def gf2_bitmatrix_transform(bitmat: torch.Tensor, x: torch.Tensor,
                            chunk_bytes: int = CHUNK_BYTES,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """(8 rows, 8 k) int8 bit-matrix, (B, k, L) uint8 -> (B, rows, L) uint8.

    x may be strided along its first two axes; its last axis must be
    contiguous. `out`, when given, is a (B, rows, L) uint8 view whose
    last axis is contiguous, strided along its first two axes and sharing
    no byte with x, and is returned. On CUDA one kernel is launched on
    the current stream and the call returns without synchronising;
    `chunk_bytes` bounds the plain version's intermediates on the CPU and
    means nothing to the kernel."""
    _check(bitmat, x)
    rows = bitmat.shape[0] // 8
    if out is not None:
        check_out(rows, x, out)
    if x.device.type == "cpu":
        got = gf2_bitmatrix_transform_reference(bitmat, x, chunk_bytes)
        return got if out is None else out.copy_(got)
    if x.device.type != "cuda":
        raise ValueError(f"no GF(2) bit-matrix kernel for device "
                         f"{x.device}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError("x's last axis must be contiguous")
    k = bitmat.shape[1] // 8
    bsz, _, length = x.shape
    if out is None:
        out = torch.empty((bsz, rows, length), dtype=torch.uint8,
                          device=x.device)
    if out.numel() == 0:
        return out
    bitmat = bitmat.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(x.data_ptr(), k, x.stride(0), x.stride(1), bsz, length,
                    bitmat.data_ptr(), rows, out.data_ptr(), out.stride(0),
                    out.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"gf2 bit-matrix kernel launch failed: CUDA "
                           f"error {err}")
    count_launch()
    count_call()
    return out


def gf2_bitmatrix_transform_reference(bitmat: torch.Tensor, x: torch.Tensor,
                                      chunk_bytes: int = CHUNK_BYTES
                                      ) -> torch.Tensor:
    """The plain PyTorch version, on any device, in uint8 ops: unpack each
    column's bits, XOR in the bit-matrix's column of every set input bit,
    pack the output bits; in `chunks` of at most chunk_bytes of planes
    and sums."""
    _check(bitmat, x)
    rows, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    bsz, _, length = x.shape
    out = torch.empty((bsz, rows, length), dtype=torch.uint8,
                      device=x.device)
    cols = bitmat.to(torch.uint8).t().contiguous()  # (8 k, 8 rows)
    live = cols.cpu().numpy().any(axis=1).tolist()
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    weights = (torch.ones(8, dtype=torch.uint8, device=x.device) << shifts)
    for b0, nb, l0, lc in chunks(bsz, length, k, rows, chunk_bytes):
        part = x[b0:b0 + nb, :, l0:l0 + lc]               # (nb, k, lc)
        planes = (part.unsqueeze(-1) >> shifts) & 1        # (nb, k, lc, 8)
        planes = planes.permute(0, 2, 1, 3).reshape(nb * lc, 8 * k)
        acc = torch.zeros((nb * lc, 8 * rows), dtype=torch.uint8,
                          device=x.device)
        for c in range(8 * k):
            if live[c]:
                acc ^= planes[:, c:c + 1] & cols[c]
        packed = (acc.view(nb, lc, rows, 8) * weights).sum(
            dim=-1, dtype=torch.uint8)                     # (nb, lc, rows)
        out[b0:b0 + nb, :, l0:l0 + lc] = packed.permute(0, 2, 1)
    return out
