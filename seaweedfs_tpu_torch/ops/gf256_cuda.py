"""The GF(256) shard transform on Hopper: the CUDA kernel's wrapper and
its plain PyTorch version.

`gf256_transform(consts, x)` applies a (rows, k) GF(256) coefficient
matrix, given as its (rows, k, 8) bitplane constants
(`gf.bitplane_constants`), to a (B, k, L) uint8 block of shard windows
and returns the (B, rows, L) result:

    out[b, r, :] = XOR_i gf_mul(coeff[r, i], x[b, i, :])

It is the port of seaweedfs_tpu/ops/gf256_pallas.py (kernel K1,
`_make_kernel`, reached through `gf256_words_transform` and
`gf256_matmul_pallas`). The CUDA source is csrc/gf256_transform.cu; see
its header for the design and what bounds it.

`gf256_chain(consts, host_in, dev_in, dev_out, host_out, bounds, ...)`
enqueues a one-window card recover as one native chain of pieces on two
streams (the copy in of a piece's survivor bytes, K1 over them and the
copy out of its columns; csrc/gf256_transform.cu's `swtpu_gf256_chain`),
so that K1 and the copy out run under the copy in of the next piece.
`piece_bounds(L)` is its plan, `stage_pieces` its staging layout.

`gf256_stacked_transform(consts, x, out=None)` is the port of kernel K2
(`_make_stacked_kernel`, reached through `gf256_stacked_transform`), the
kernel every device block of parallel/mesh.py runs. On the TPU, K2 is a
second Pallas kernel only because a Pallas kernel's refs follow its
BlockSpecs; the CUDA kernel already takes one strided (B, k, L) block, so
K2 launches the same kernel. It can write into a caller's (B, rows, L)
view (`out=`), and it counts its launches apart, in `stacked_launches`.

On a CUDA tensor each wrapper launches the kernel or raises. On a CPU
tensor it runs its plain version (`gf256_transform_reference`,
`gf256_stacked_transform_reference`), which the tests compare with the
JAX package and chip_smoke.py compares with the kernel on the card.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from contextlib import nullcontext

import numpy as np
import torch

from ..native import build as native_build
from . import _build

MAX_ROWS = 16
MAX_K = 16

# kernel launches made by gf256_transform and by gf256_stacked_transform,
# the counts chip_smoke.py reads to show which path went through which.
# A volume server launches from several executor threads at once (an
# admin request, a degraded read, the scrubber), so each count is raised
# under _count_lock: a bare `+= 1` on a module global can lose a launch.
launches = 0
stacked_launches = 0
_count_lock = threading.Lock()


def count_launch(stacked: bool = False, n: int = 1) -> None:
    """Add n to `launches`, or to `stacked_launches`, under the lock."""
    global launches, stacked_launches
    with _count_lock:
        if stacked:
            stacked_launches += n
        else:
            launches += n

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


_CHAIN_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p]


@functools.cache
def _kernel():
    lib = _build.load("gf256_transform")
    fn = lib.swtpu_gf256_transform
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _chain_lib():
    """The library's chain entry points, their types set."""
    lib = _build.load("gf256_transform")
    lib.swtpu_gf256_chain.argtypes = _CHAIN_ARGTYPES
    lib.swtpu_chain_events.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_void_p)]
    lib.swtpu_chain_wait.argtypes = [ctypes.c_void_p]
    for fn in (lib.swtpu_gf256_chain, lib.swtpu_chain_events,
               lib.swtpu_chain_wait):
        fn.restype = ctypes.c_int
    return lib


def _check(consts: torch.Tensor, x: torch.Tensor) -> None:
    if not isinstance(consts, torch.Tensor) or not isinstance(x, torch.Tensor):
        raise TypeError("gf256_transform takes torch tensors")
    if consts.dtype != torch.uint8 or x.dtype != torch.uint8:
        raise TypeError(f"gf256_transform takes uint8 tensors, got "
                        f"consts {consts.dtype} and x {x.dtype}")
    if consts.dim() != 3 or consts.shape[2] != 8:
        raise ValueError(f"consts must be (rows, k, 8), got "
                         f"{tuple(consts.shape)}")
    rows, k, _ = consts.shape
    if not (1 <= rows <= MAX_ROWS and 1 <= k <= MAX_K):
        raise ValueError(f"the kernel takes 1..{MAX_ROWS} rows and "
                         f"1..{MAX_K} inputs, got rows={rows} k={k}")
    if x.dim() != 3 or x.shape[1] != k:
        raise ValueError(f"x must be (B, {k}, L), got {tuple(x.shape)}")
    if x.device != consts.device:
        raise ValueError(f"consts on {consts.device}, x on {x.device}")


def _spans(t: torch.Tensor) -> tuple[np.ndarray, int]:
    """Start addresses of the (B, R) byte rows of a 3-D uint8 tensor, and
    the byte length each row spans."""
    bsz, rows, length = t.shape
    starts = (t.data_ptr() + np.arange(bsz, dtype=np.int64)[:, None]
              * t.stride(0) + np.arange(rows, dtype=np.int64)[None, :]
              * t.stride(1))
    return starts.ravel(), (length - 1) * t.stride(2) + 1


def _overlaps(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether any byte of a lies in a row of b (exact for rows whose
    last axis is contiguous, conservative otherwise)."""
    if a.numel() == 0 or b.numel() == 0:
        return False
    a_starts, a_len = _spans(a)
    b_starts, b_len = _spans(b)
    b_starts = np.sort(b_starts)
    # the b row that starts last before each a row ends reaches furthest
    last = np.searchsorted(b_starts, a_starts + a_len, side="left") - 1
    hit = last >= 0
    return bool(np.any(b_starts[last[hit]] + b_len > a_starts[hit]))


def check_out(rows: int, x: torch.Tensor, out: torch.Tensor) -> None:
    """out must be a (B, rows, L) uint8 view on x's device whose last axis
    is contiguous and which shares no byte with x."""
    if not isinstance(out, torch.Tensor):
        raise TypeError("out must be a torch tensor")
    if out.dtype != torch.uint8:
        raise TypeError(f"out must be uint8, got {out.dtype}")
    want = (x.shape[0], rows, x.shape[2])
    if tuple(out.shape) != want:
        raise ValueError(f"out must be {want}, got {tuple(out.shape)}")
    if out.device != x.device:
        raise ValueError(f"x on {x.device}, out on {out.device}")
    if out.shape[2] > 1 and out.stride(2) != 1:
        raise ValueError("out's last axis must be contiguous")
    if _overlaps(out, x):
        raise ValueError("out overlaps x")


def _launch(consts: torch.Tensor, x: torch.Tensor,
            out: torch.Tensor) -> bool:
    """Launch the kernel on the current stream without synchronising;
    False when there was nothing to compute."""
    if x.device.type != "cuda":
        raise ValueError(f"no GF(256) kernel for device {x.device}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError("x's last axis must be contiguous")
    if out.numel() == 0:
        return False
    consts = consts.contiguous()
    rows, k, _ = consts.shape
    bsz, _, length = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _kernel()(consts.data_ptr(), rows, k, x.data_ptr(), x.stride(0),
                    x.stride(1), out.data_ptr(), out.stride(0),
                    out.stride(1), bsz, length, stream)
    if err != 0:
        raise RuntimeError(f"gf256 kernel launch failed: CUDA error {err}")
    return True


def _transform(consts: torch.Tensor, x: torch.Tensor,
               out: torch.Tensor | None, stacked: bool) -> torch.Tensor:
    """The body of both wrappers; `stacked` picks the count raised."""
    _check(consts, x)
    if out is None:
        out = torch.empty((x.shape[0], consts.shape[0], x.shape[2]),
                          dtype=torch.uint8, device=x.device)
    else:
        check_out(consts.shape[0], x, out)
    if x.device.type == "cpu":
        return _reference_into(consts, x, out)
    if _launch(consts, x, out):
        count_launch(stacked)
    return out


def gf256_transform(consts: torch.Tensor, x: torch.Tensor,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, k, 8) constants, (B, k, L) uint8 -> (B, rows, L) uint8.

    x may be a strided view along its first two axes (for example the
    data rows of a (B, k+m, L) block); its last axis must be contiguous.
    `out`, when given, is a (B, rows, L) view under the contract of
    gf256_stacked_transform's, and is returned. On CUDA the kernel is
    launched on the current stream and the call returns without
    synchronising."""
    return _transform(consts, x, out, stacked=False)


# The chain's plan. Below CHAIN_MIN_BYTES a window is one piece (the
# serial order); from it up, pieces of PIECE_BYTES or more, at most
# MAX_PIECES of them, each a multiple of 16 bytes but the last, so every
# piece's columns start where K1's 16-byte vector path can read them.
CHAIN_MIN_BYTES = 512 << 10
PIECE_BYTES = 256 << 10
MAX_PIECES = 8
_PIECE_ALIGN = 16


def split_bounds(length: int, pieces: int) -> list[int]:
    """[0, ..., length]: `pieces` pieces of one size, a multiple of 16
    bytes, and a ragged last one (fewer pieces where the rounding leaves
    nothing for the last)."""
    if length <= 0 or pieces <= 1:
        return [0, max(length, 0)]
    size = -(-length // pieces)
    size = -(-size // _PIECE_ALIGN) * _PIECE_ALIGN
    return list(range(0, length, size)) + [length]


def piece_bounds(length: int) -> list[int]:
    """The piece plan of a chain over a window of `length` bytes, as its
    P + 1 bounds: a function of the length alone."""
    if length < CHAIN_MIN_BYTES:
        return split_bounds(length, 1)
    return split_bounds(length, min(MAX_PIECES, length // PIECE_BYTES))


class ChainEvents:
    """MAX_PIECES + 1 events of one chain: one for each piece's copy in,
    and `done`, the last. A group is taken from a pool per device and
    given back once its chain's `done` has completed, so no event is
    recorded again while a wait on it may still be pending."""

    def __init__(self):
        self.handles = (ctypes.c_void_p * (MAX_PIECES + 1))()
        err = _chain_lib().swtpu_chain_events(MAX_PIECES + 1, self.handles)
        if err != 0:
            raise RuntimeError(f"chain event creation failed: CUDA error "
                               f"{err}")

    @property
    def done(self) -> int:
        return self.handles[MAX_PIECES]

    def wait(self) -> None:
        """Block until the chain's `done` has completed; ctypes releases
        the interpreter's lock meanwhile."""
        err = _chain_lib().swtpu_chain_wait(self.done)
        if err != 0:
            raise RuntimeError(f"chain wait failed: CUDA error {err}")


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


# free event groups by device index; list.append and list.pop are atomic
# under the interpreter's lock, so a group can be given back from a
# finaliser that runs inside another thread's take
_event_pools: dict[int, list] = {}


def take_events(device: torch.device) -> ChainEvents:
    """A free event group of `device`, made when the pool has none."""
    index = _index(device)
    try:
        return _event_pools.setdefault(index, []).pop()
    except IndexError:
        with torch.cuda.device(index):
            return ChainEvents()


def give_events(device: torch.device, events: ChainEvents) -> None:
    """Return a group whose chain's `done` has completed."""
    _event_pools.setdefault(_index(device), []).append(events)


def chain_streams(device: torch.device) -> tuple:
    """(A, B): two streams of torch's pool on `device`, made once. They do
    not synchronise with the legacy default stream, so nothing else's work
    serialises a chain."""
    return _chain_streams(_index(device))


@functools.cache
def _chain_streams(index: int) -> tuple:
    return torch.cuda.Stream(index), torch.cuda.Stream(index)


def stage_pieces(rows, bounds: list[int], out: np.ndarray) -> np.ndarray:
    """Copy a window of k equal-length byte rows (a sequence of 1-D uint8
    arrays, or a (k, L) array) into the flat k x L buffer `out`
    piece-major: piece [a, b)'s (k, b - a) rows at k x a, each row
    b - a bytes, the chain's staging layout. One call of the native host
    library (native/stage.c) where it is built, else numpy. Returns
    out."""
    k = len(rows)
    if out.dtype != np.uint8 or not out.flags.c_contiguous \
            or out.size < k * bounds[-1]:
        raise ValueError("out must be a contiguous uint8 buffer of k x L "
                         "bytes")
    rows = [np.ascontiguousarray(r, dtype=np.uint8) for r in rows]
    if any(r.size < bounds[-1] for r in rows):
        raise ValueError("a row is shorter than the window")
    lib = native_build.load()
    if lib is not None:
        lib.swtpu_stage_pieces(
            (ctypes.c_void_p * k)(*[r.ctypes.data for r in rows]), k,
            (ctypes.c_longlong * len(bounds))(*bounds), len(bounds) - 1,
            out.ctypes.data)
        return out
    for a, b in zip(bounds, bounds[1:]):
        piece = out[k * a:k * b].reshape(k, b - a)
        for i in range(k):
            piece[i] = rows[i][a:b]
    return out


def gf256_chain(consts: torch.Tensor, host_in: torch.Tensor,
                dev_in: torch.Tensor, dev_out: torch.Tensor,
                host_out: torch.Tensor, bounds: list[int],
                streams: tuple | None = None,
                events: ChainEvents | None = None,
                transform=None) -> None:
    """Enqueue the recover of one window of k rows of L bytes as one
    chain of pieces: for each piece [bounds[i], bounds[i + 1]) of L, the
    copy of its survivor bytes from host_in into dev_in on streams[0],
    then on streams[1] K1 over them into the piece's columns of dev_out
    and the copy of those columns into host_out; `events.done` is recorded
    on streams[1] after the last.

    host_in (pinned) and dev_in are flat k x L uint8 tensors staged
    piece-major (`stage_pieces`); dev_out and host_out (pinned) are
    contiguous (1, rows, L). The caller keeps them and `events` until
    `events.done` completes. On CUDA it launches (counting one K1 launch
    a piece) or raises.

    `transform` is the K1 of the chain, gf256_transform unless given. The
    native chain launches gf256_transform's kernel itself; any other
    transform (a caller's stand-in for K1), and CPU tensors, run the same
    pieces in order from here, each piece's result written into dev_out's
    columns, then one copy of dev_out into host_out; on CUDA on
    streams[1], waited for before the call returns."""
    rows, k = consts.shape[0], consts.shape[1]
    length = dev_out.shape[-1]
    shapes = ((host_in, (k * length,)), (dev_in, (k * length,)),
              (dev_out, (1, rows, length)), (host_out, (1, rows, length)))
    for t, want in shapes:
        if tuple(t.shape) != want or t.dtype != torch.uint8 \
                or not t.is_contiguous():
            raise ValueError(f"chain buffers must be contiguous uint8 "
                             f"{want}, got {tuple(t.shape)} {t.dtype}")
    _check(consts, dev_in.view(1, k, length))
    pieces = len(bounds) - 1
    if not 1 <= pieces <= MAX_PIECES or bounds[0] != 0 \
            or bounds[-1] != length \
            or any(b <= a for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"bad piece bounds {bounds} for L={length}")
    if dev_in.device != dev_out.device:
        raise ValueError(f"dev_in on {dev_in.device}, dev_out on "
                         f"{dev_out.device}")
    card = dev_in.device.type == "cuda"
    if transform not in (None, gf256_transform) or not card:
        with torch.cuda.stream(streams[1]) if card else nullcontext():
            for a, b in zip(bounds, bounds[1:]):
                dev_in[k * a:k * b].copy_(host_in[k * a:k * b],
                                          non_blocking=True)
                cols = dev_out[..., a:b]
                y = (transform or gf256_transform)(
                    consts, dev_in[k * a:k * b].view(1, k, b - a), cols)
                if y is not cols:
                    cols.copy_(y)
            host_out.copy_(dev_out, non_blocking=True)
        if card:
            streams[1].synchronize()
        return
    consts = consts.contiguous()
    stream_a, stream_b = streams
    err = _chain_lib().swtpu_gf256_chain(
        consts.data_ptr(), rows, k, host_in.data_ptr(), dev_in.data_ptr(),
        dev_out.data_ptr(), host_out.data_ptr(), length,
        (ctypes.c_longlong * (pieces + 1))(*bounds), pieces,
        stream_a.cuda_stream, stream_b.cuda_stream, events.handles,
        events.done)
    if err != 0:
        raise RuntimeError(f"gf256 chain failed: CUDA error {err}")
    count_launch(n=pieces)


def gf256_stacked_transform(consts: torch.Tensor, x: torch.Tensor,
                            out: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """K2's port: (rows, k, 8) constants, (B, k, L) uint8 -> (B, rows, L).

    Computes what gf256_transform does, into `out` when it is given: a
    (B, rows, L) uint8 view whose last axis is contiguous, whose batch
    and row axes may be strided (for example the parity rows of a
    (B, k+m, L) block), and which overlaps x nowhere. Returns out."""
    return _transform(consts, x, out, stacked=True)


def _reference_into(consts: torch.Tensor, x: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """uint8 mask form of seaweedfs_tpu/ec/encoder_jax.py::_apply_bitplanes:
    for every set bit j of an input byte, XOR in gf_mul(c, 1 << j)."""
    rows, k, _ = consts.shape
    table = consts.cpu().tolist()
    out.zero_()
    for i in range(k):
        xi = x[:, i, :]
        for j in range(8):
            cs = [table[r][i][j] for r in range(rows)]
            if not any(cs):
                continue
            # 0x00/0xFF mask of bit j of every byte of input i
            mask = ((xi >> j) & 1) * 0xFF
            for r, c in enumerate(cs):
                if c:
                    out[:, r, :] ^= mask & c
    return out


def gf256_transform_reference(consts: torch.Tensor,
                              x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of gf256_transform, on any device."""
    _check(consts, x)
    out = torch.empty((x.shape[0], consts.shape[0], x.shape[2]),
                      dtype=torch.uint8, device=x.device)
    return _reference_into(consts, x, out)


def gf256_stacked_transform_reference(consts: torch.Tensor, x: torch.Tensor,
                                      out: torch.Tensor | None = None
                                      ) -> torch.Tensor:
    """The plain PyTorch version of gf256_stacked_transform, on any
    device; writes into `out` under the same contract."""
    _check(consts, x)
    if out is None:
        return gf256_transform_reference(consts, x)
    check_out(consts.shape[0], x, out)
    return _reference_into(consts, x, out)
