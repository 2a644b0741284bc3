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

import numpy as np
import torch

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


def count_launch(stacked: bool = False) -> None:
    """Add one to `launches`, or to `stacked_launches`, under the lock."""
    global launches, stacked_launches
    with _count_lock:
        if stacked:
            stacked_launches += 1
        else:
            launches += 1

_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]


@functools.cache
def _kernel():
    lib = _build.load("gf256_transform")
    fn = lib.swtpu_gf256_transform
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
