"""CRC32C of every row of a byte array on Hopper: the CUDA kernel's
wrapper and its plain PyTorch version.

`crc32c_batch(data)` takes a (B, n) uint8 tensor and returns the (B,)
CRC32C of its rows, bit-exact with util/crc32c.crc32c, as an int64 tensor
holding the uint32 values (torch's uint32 has thin operator coverage on
the CPU). It is the port of seaweedfs_tpu/ops/crc32c_jax.py (kernel K5,
`crc32c_batch`); the CUDA source is csrc/crc32c.cu, whose header gives
the design and what bounds it. Nothing on the port's read or write path
calls it: in the JAX package only bench.py does.

On a CUDA tensor the wrapper launches the kernel or raises. On a CPU
tensor it runs its plain version (`crc32c_batch_reference`): the JAX
formulation in torch, the LSB-first bits of each block times BlockMat,
the block states times PowMat, both mod 2, packed and XORed with the
affine constant. Its products run in float32, which is exact here: the
terms are 0 or 1 and a sum is at most K * 32 <= 2^17 < 2^24.

`_advance`, `_matrices` and `_pick_block` are copies of crc32c_jax.py's;
`fold_operators` builds the kernel's per-level operators from the same
algebra.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build

_POLY = 0x82F63B78  # reflected Castagnoli

_T = np.zeros(256, np.uint32)
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_POLY ^ (_c >> 1)) if (_c & 1) else (_c >> 1)
    _T[_i] = _c

# the kernel's segment: one thread's bytes, and the stage-1 block's most
# segments (csrc/crc32c.cu kSeg, kBlockSegs)
SEG = 256
BLOCK_SEGS = 256

# calls that launched the kernel (its two stages count once), the count
# chip_smoke.py reads
launches = 0
_count_lock = threading.Lock()


def count_launch() -> None:
    global launches
    with _count_lock:
        launches += 1


def _advance(states: np.ndarray) -> np.ndarray:
    """One zero-byte advance A8 applied to u32-encoded GF(2) states."""
    return (states >> np.uint32(8)) ^ _T[states & np.uint32(0xFF)]


@functools.lru_cache(maxsize=16)
def _matrices(n: int, block: int) -> tuple[np.ndarray, np.ndarray, int]:
    """(BlockMat (block*8, 32) int8, PowMat (K*32, 32) int8, affine u32)
    for messages of exactly n bytes split into K = n/block blocks."""
    assert n % block == 0 and n > 0
    k_blocks = n // block
    # columns for byte j, bit b inside ONE block: A8^(block-1-j)(T[1<<b])
    base = _T[np.left_shift(1, np.arange(8))].astype(np.uint32)  # (8,)
    cols = np.zeros((block, 8), np.uint32)
    cur = base.copy()
    for j in range(block - 1, -1, -1):
        cols[j] = cur
        cur = _advance(cur)
    # BlockMat bits: (block*8, 32)
    bm = ((cols.reshape(block * 8, 1)
           >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int8)
    # block-advance operator C = A8^block as 32 u32 columns
    c_cols = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for _ in range(block):
        c_cols = _advance(c_cols)

    def apply_c(v: np.ndarray) -> np.ndarray:
        out = np.zeros_like(v)
        for b in range(32):
            out ^= np.where((v >> np.uint32(b)) & 1, c_cols[b],
                            np.uint32(0))
        return out

    # PowMat: block m's state passes through C^(K-1-m); build backwards
    pw = np.zeros((k_blocks, 32), np.uint32)
    cur = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    for m in range(k_blocks - 1, -1, -1):
        pw[m] = cur
        cur = apply_c(cur)
    pm = ((pw.reshape(k_blocks * 32, 1)
           >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int8)
    # affine part: A8^n(0xFFFFFFFF). After the loop above `cur` holds the
    # columns of C^K = A8^n, and all-ones init means XOR of every column.
    aff = np.bitwise_xor.reduce(cur)
    return bm, pm, int(aff)


def _pick_block(n: int) -> int:
    for b in (256, 128, 64, 32, 16, 8, 4, 2, 1):
        if n % b == 0:
            return b
    return 1


# --- the kernel's host-side algebra -----------------------------------------

_IDENTITY = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))


def apply_operator(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A GF(2) operator given as its 32 uint32 columns, applied to each
    uint32 state of v."""
    v = np.asarray(v, np.uint32)
    out = np.zeros_like(v)
    for b in range(32):
        out ^= np.where((v >> np.uint32(b)) & 1, cols[b], np.uint32(0))
    return out


def slicing_tables() -> np.ndarray:
    """The kernel's 8 x 256 slicing-by-8 tables: row 0 is the byte table,
    row k the byte table advanced by k zero bytes."""
    t = np.zeros((8, 256), np.uint32)
    t[0] = _T
    for k in range(1, 8):
        t[k] = _advance(t[k - 1])
    return t


def fold_geometry(n: int) -> tuple[int, int]:
    """(segments, levels) of an n-byte row: ceil(n / SEG) segments, padded
    in front to 2^levels, the least power of two that holds them."""
    if n < 1:
        raise ValueError(f"rows must hold at least one byte, got n={n}")
    segs = -(-n // SEG)
    return segs, (segs - 1).bit_length()


@functools.lru_cache(maxsize=64)
def fold_operators(n: int) -> tuple[np.ndarray, int]:
    """The kernel's operators for n-byte rows: (levels + 1, 32) uint32,
    row j the columns of A8^(SEG * 2^j), and the affine constant
    A8^n(0xFFFFFFFF), both built by squaring A8."""
    _, levels = fold_geometry(n)
    op = _IDENTITY.copy()
    for _ in range(SEG):
        op = _advance(op)
    ops = np.zeros((levels + 1, 32), np.uint32)
    for j in range(levels + 1):
        ops[j] = op
        op = apply_operator(op, op)  # columns of op(op(.))
    power, a = _IDENTITY.copy(), _advance(_IDENTITY.copy())
    rest = n
    while rest:
        if rest & 1:
            power = apply_operator(a, power)
        a = apply_operator(a, a)
        rest >>= 1
    return ops, int(np.bitwise_xor.reduce(power))


# --- the wrapper ----------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _kernel():
    fn = _build.load("crc32c").swtpu_crc32c_batch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _as_device_words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device)


@functools.lru_cache(maxsize=16)
def _device_tables(device: torch.device) -> torch.Tensor:
    return _as_device_words(slicing_tables(), device)


@functools.lru_cache(maxsize=64)
def _device_operators(device: torch.device, n: int) -> torch.Tensor:
    return _as_device_words(fold_operators(n)[0], device)


def _check(data: torch.Tensor) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError("crc32c_batch takes a torch tensor")
    if data.dtype != torch.uint8:
        raise TypeError(f"crc32c_batch takes uint8, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (B, n), got {tuple(data.shape)}")
    if data.shape[1] < 1:
        raise ValueError("rows must hold at least one byte")


def crc32c_batch(data: torch.Tensor, block: int | None = None
                 ) -> torch.Tensor:
    """(B, n) uint8 -> (B,) int64 CRC32C of each row.

    On CUDA the rows may be strided but each must be contiguous; the
    kernel is launched on the current stream and the call returns without
    synchronising. `block` only shapes the plain version's products (the
    result does not depend on it); the kernel ignores it."""
    _check(data)
    if data.device.type == "cpu":
        return crc32c_batch_reference(data, block)
    if data.device.type != "cuda":
        raise ValueError(f"no CRC32C kernel for device {data.device}")
    if data.shape[1] > 1 and data.stride(1) != 1:
        raise ValueError("each row must be contiguous")
    rows, n = data.shape
    out = torch.empty(rows, dtype=torch.int64, device=data.device)
    if rows == 0:
        return out
    _, levels = fold_geometry(n)
    _, aff = fold_operators(n)
    parts = (1 << levels) >> min(levels, BLOCK_SEGS.bit_length() - 1)
    partial = torch.empty((rows, parts), dtype=torch.int32,
                          device=data.device)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _kernel()(data.data_ptr(), data.stride(0), rows, n,
                    _device_tables(data.device).data_ptr(),
                    _device_operators(data.device, n).data_ptr(), levels,
                    aff, partial.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crc32c kernel launch failed: CUDA error {err}")
    count_launch()
    return out


@contextlib.contextmanager
def _full_float32():
    """Float32 products in full precision on the card (TF32 off)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def crc32c_batch_reference(data: torch.Tensor, block: int | None = None
                           ) -> torch.Tensor:
    """The plain PyTorch version of crc32c_batch, on any device: the
    GF(2) products of crc32c_jax.py in float32, mod 2."""
    _check(data)
    rows, n = data.shape
    blk = block or _pick_block(n)
    bm, pm, aff = _matrices(n, blk)
    k_blocks = n // blk
    dev = data.device
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    # LSB-first bits: (B, n) -> (B, K, blk * 8) in {0, 1}
    bits = ((data.unsqueeze(-1) >> shifts) & 1).reshape(
        rows, k_blocks, blk * 8).to(torch.float32)
    with _full_float32():
        y = torch.remainder(
            bits @ torch.from_numpy(bm).to(dev, torch.float32), 2)
        del bits
        s = torch.remainder(
            y.reshape(rows, k_blocks * 32)
            @ torch.from_numpy(pm).to(dev, torch.float32), 2)
    weights = torch.pow(2, torch.arange(32, dtype=torch.int64, device=dev))
    state = (s.to(torch.int64) * weights).sum(-1)
    return state ^ (aff ^ 0xFFFFFFFF)
