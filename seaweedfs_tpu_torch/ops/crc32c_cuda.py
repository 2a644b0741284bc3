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
`fold_tables`, `woven_tables` and `affine` build the kernel's fold
operators, its tables for the woven layout and the affine constant from
the same algebra, and `table_image`, `entry_offset`, `span_layout`,
`tile_slots`, `woven_layout` and `pick_span` state its table layout and
geometry on the host, where tests/test_torch_crc32c.py's model of the
kernel reads them. `launch_kernel` also runs the variants of the split
that chip_smoke.py times; only `crc32c_batch` counts launches.
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

# the kernel's geometry (csrc/crc32c.cu): slots of a tile (threads of a
# stage-1 block), the span sizes the wrapper picks from, largest first, and
# the slicing width of its tables
TILE = 1024
SPANS = (512, 256, 128, 64)
SLICE = 4
# a thread's share of a tile's fold, in bytes of span work it equals (about
# 130 instructions against 3.75 a byte): pick_span's cost model
FOLD_BYTES = 35

# calls that launched the kernel (its stages count once), the count
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
    """The 8 x 256 slicing tables the kernel fills its shared memory from
    (slicing-by-4 takes the first four, the split's slicing-by-8 all
    eight): row 0 is the byte table, row k the byte table advanced by k
    zero bytes."""
    t = np.zeros((8, 256), np.uint32)
    t[0] = _T
    for k in range(1, 8):
        t[k] = _advance(t[k - 1])
    return t


def _power(cols: np.ndarray, k: int) -> np.ndarray:
    """The columns of an operator's k-th power, by squaring."""
    out = _IDENTITY.copy()
    while k:
        if k & 1:
            out = apply_operator(cols, out)
        cols = apply_operator(cols, cols)
        k >>= 1
    return out


def _advance_by(k: int) -> np.ndarray:
    """The columns of A8^k: k zero-byte advances of the register."""
    return _power(_advance(_IDENTITY.copy()), k)


def _inverse(cols: np.ndarray) -> np.ndarray:
    """The columns of an invertible GF(2) operator's inverse (Gauss-Jordan
    on the 32 x 32 bit matrix)."""
    bit = np.arange(32, dtype=np.uint32)
    m = ((cols[None, :] >> bit[:, None]) & 1).astype(np.uint8)  # m[i, b]
    aug = np.concatenate([m, np.eye(32, dtype=np.uint8)], axis=1)
    for c in range(32):
        pivot = c + int(np.flatnonzero(aug[c:, c])[0])
        aug[[c, pivot]] = aug[[pivot, c]]
        rows = np.flatnonzero(aug[:, c])
        aug[rows[rows != c]] ^= aug[c]
    inv = aug[:, 32:].astype(np.uint32)
    return np.bitwise_or.reduce(inv << bit[:, None], axis=0)


def woven_tables(slice_: int = SLICE) -> np.ndarray:
    """The tables of the woven layout, (slice_, 256): slicing_tables()'s
    first slice_ rows, each entry advanced further over the 31 units of
    slice_ bytes that the warp's other lanes read before the lane's next
    unit (A8^(31 slice_) after each)."""
    return apply_operator(_advance_by(31 * slice_),
                          slicing_tables()[:slice_])


def table_image(slice_: int = SLICE, woven: bool = False) -> np.ndarray:
    """The kernel's tables as it lays them out in shared memory, as
    32-bit words: the first `slice_` tables of slicing_tables() (or of
    woven_tables), each entry 128 // slice_ times over, so entry e of
    table k for lane l sits at word (k 256 + e) copies + l % copies and a
    lane reads only its own bank."""
    t = woven_tables(slice_) if woven else slicing_tables()[:slice_]
    return np.repeat(t.reshape(-1), 128 // slice_)


def entry_offset(c: int, byte: int, lane: int, slice_: int = SLICE) -> int:
    """Byte offset, inside table 0 of table_image(slice_), of the entry that
    byte `byte` of c indexes in lane's copy: the kernel's one shift and one
    LOP3 (csrc/crc32c.cu entry), the byte masked in place and the lane's
    bank ORed in below it."""
    shift = 7 if slice_ == 4 else 6  # log2 of an entry's bytes
    sh = 8 * byte - shift
    x = c >> sh if sh >= 0 else (c << -sh) & 0xFFFFFFFF
    return (x & (0xFF << shift)) | (lane % (128 // slice_)) * 4


def span_layout(n: int, span: int) -> tuple[int, int]:
    """(m, levels) of an n-byte row in spans of `span` bytes: m =
    ceil(n / span) spans, padded in front to 2^levels slots, the least
    power of two that holds them."""
    if n < 1:
        raise ValueError(f"rows must hold at least one byte, got n={n}")
    m = -(-n // span)
    return m, (m - 1).bit_length()


def span_bounds(n: int, span: int) -> tuple[np.ndarray, np.ndarray]:
    """[begin, end) of each span of an n-byte row, aligned to the row's
    end: span s ends at n - (m - 1 - s) span, and only span 0 is cut
    short (at 0)."""
    m, _ = span_layout(n, span)
    end = n - (m - 1 - np.arange(m, dtype=np.int64)) * span
    return np.maximum(end - span, 0), end


def tile_count(rows: int, n: int, span: int) -> int:
    """Tiles of TILE slots: TILE / 2^levels whole rows each, or 2^levels /
    TILE tiles a row."""
    _, levels = span_layout(n, span)
    tile_levels = TILE.bit_length() - 1
    if levels <= tile_levels:
        return -(-rows // (TILE >> levels))
    return rows << (levels - tile_levels)


def tile_slots(tile: int, n: int, span: int) -> tuple[np.ndarray, np.ndarray]:
    """(row, span) of each thread of a tile, as the kernel's locate: a
    span below 0 is a zero slot in front of its row, and a row past the
    last is the caller's to drop."""
    m, levels = span_layout(n, span)
    tile_levels = TILE.bit_length() - 1
    tid = np.arange(TILE, dtype=np.int64)
    if levels <= tile_levels:
        row = (tile << (tile_levels - levels)) + (tid >> levels)
        slot = tid & ((1 << levels) - 1)
    else:
        row = np.full(TILE, tile >> (levels - tile_levels), np.int64)
        slot = ((tile & ((1 << (levels - tile_levels)) - 1))
                << tile_levels) | tid
    return row, slot - ((1 << levels) - m)


def pick_span(rows: int, n: int, sms: int) -> int:
    """The span the wrapper launches with: of SPANS, the one whose busiest
    block (tiles dealt round robin to `sms` blocks) has the least work, a
    tile counted as TILE spans plus their fold; the larger on a tie."""
    return min(SPANS, key=lambda span: -(-tile_count(rows, n, span) // sms)
               * (span + FOLD_BYTES))


def woven_layout(ptr: int, stride: int, rows: int, n: int, span: int,
                 slice_: int = SLICE) -> bool:
    """Whether the kernel weaves its warps' regions for these rows: each
    warp's 32 spans lie in one row (at least 32 spans a row), and every
    unit of slice_ bytes is whole and aligned (n, the first row's address
    and the stride multiples of slice_). Otherwise each thread reads its
    span contiguously."""
    _, levels = span_layout(n, span)
    return (levels >= 5 and n % slice_ == 0 and ptr % slice_ == 0
            and (rows == 1 or stride % slice_ == 0))


@functools.lru_cache(maxsize=16)
def fold_tables(span: int, woven: int = 0) -> np.ndarray:
    """The kernel's fold operators for spans of `span` bytes, (3, 33, 32)
    uint32: [t, k] holds the 32 columns of A8^(span 32^t k), the advance
    of a state by k lanes (t = 0), k warps (t = 1) or k tiles (t = 2).
    With `woven` (the unit's bytes) the lane operators are A8^(woven (k -
    31)) instead: a woven lane's state has been advanced over 31 units past
    its last one, where lane 31 - k needs 31 - k."""
    step = _advance_by(span)
    out = np.zeros((3, 33, 32), np.uint32)
    for t in range(3):
        cur = _IDENTITY.copy()
        for k in range(33):
            out[t, k] = cur
            cur = apply_operator(step, cur)  # columns of step(cur(.))
        step = _power(step, 32)
    if woven:
        back = _power(_inverse(_advance_by(1)), woven)
        cur = _IDENTITY.copy()
        for k in range(31, -1, -1):
            out[0, k] = cur
            cur = apply_operator(back, cur)
        out[0, 32] = _IDENTITY
    return out


def fold_words(span: int, woven: int = 0) -> np.ndarray:
    """fold_tables(span, woven) as the kernel reads it: the lane, warp
    and tile operators for k < 32, each table transposed (column b of
    operator k at word 32 b + k, so lanes that apply distinct operators
    read distinct banks), then the tile operator for k = 32."""
    f = fold_tables(span, woven)
    return np.concatenate([f[0, :32].T.ravel(), f[1, :32].T.ravel(),
                           f[2, :32].T.ravel(), f[2, 32]])


@functools.lru_cache(maxsize=64)
def affine(n: int) -> int:
    """A8^n(0xFFFFFFFF), the CRC's affine constant for n-byte rows."""
    return int(np.bitwise_xor.reduce(_advance_by(n)))


# --- the wrapper ----------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint32,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("crc32c")
    lib.swtpu_crc32c_batch.argtypes = _ARGTYPES
    lib.swtpu_crc32c_batch.restype = ctypes.c_int
    lib.swtpu_crc32c_split.argtypes = [ctypes.c_int, ctypes.c_int,
                                       *_ARGTYPES]
    lib.swtpu_crc32c_split.restype = ctypes.c_int
    lib.swtpu_crc32c_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes() -> int:
    """Dynamic shared memory of a stage-1 block (the built kernel's)."""
    return _library().swtpu_crc32c_smem_bytes()


def _as_device_words(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(
        device)


@functools.lru_cache(maxsize=16)
def _device_tables(device: torch.device, woven: int) -> torch.Tensor:
    return _as_device_words(
        woven_tables(woven) if woven else slicing_tables(), device)


@functools.lru_cache(maxsize=64)
def _device_fold(device: torch.device, span: int, woven: int
                 ) -> torch.Tensor:
    return _as_device_words(fold_words(span, woven), device)


@functools.lru_cache(maxsize=16)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(data: torch.Tensor) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError("crc32c_batch takes a torch tensor")
    if data.dtype != torch.uint8:
        raise TypeError(f"crc32c_batch takes uint8, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (B, n), got {tuple(data.shape)}")
    if data.shape[1] < 1:
        raise ValueError("rows must hold at least one byte")


def launch_kernel(data: torch.Tensor, span: int | None = None,
                  variant: int | None = None, stages: int = 3,
                  woven: bool = True) -> torch.Tensor:
    """Launch the kernel on the (B, n) uint8 CUDA tensor `data` and return
    the (B,) int64 output, counting nothing. `span` overrides pick_span,
    and woven=False reads every span contiguously where woven_layout
    would weave; `variant` and `stages` select one of the split's
    variants (csrc/crc32c.cu swtpu_crc32c_split), which chip_smoke.py
    times apart."""
    _check(data)
    if data.device.type != "cuda":
        raise ValueError(f"no CRC32C kernel for device {data.device}")
    if data.shape[1] > 1 and data.stride(1) != 1:
        raise ValueError("each row must be contiguous")
    rows, n = data.shape
    out = torch.empty(rows, dtype=torch.int64, device=data.device)
    if rows == 0:
        return out
    sms = sm_count(data.device)
    span = span or pick_span(rows, n, sms)
    slice_ = 8 if variant == 4 else SLICE
    woven = woven and woven_layout(data.data_ptr(), data.stride(0), rows,
                                   n, span, slice_)
    unit = slice_ if woven else 0
    _, levels = span_layout(n, span)
    partial = torch.empty(
        tile_count(rows, n, span) if levels > TILE.bit_length() - 1 else 1,
        dtype=torch.int32, device=data.device)
    args = (data.data_ptr(), data.stride(0), rows, n, span, sms, int(woven),
            _device_tables(data.device, unit).data_ptr(),
            _device_fold(data.device, span, unit).data_ptr(), affine(n),
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(data.device).cuda_stream)
    lib = _library()
    err = (lib.swtpu_crc32c_batch(*args) if variant is None
           else lib.swtpu_crc32c_split(variant, stages, *args))
    if err != 0:
        raise RuntimeError(f"crc32c kernel launch failed: CUDA error {err}")
    return out


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
    out = launch_kernel(data)
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
