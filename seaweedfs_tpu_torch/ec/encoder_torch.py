"""Torch RS(10,4) encoder — the GF(256) shard transform on the card.

The port of seaweedfs_tpu/ec/encoder_jax.py. A (rows, k) GF(256)
coefficient matrix applied to k shard byte streams is evaluated by the
hand-written CUDA kernel in ops/gf256_cuda.py (bitplane form:
gf_mul(c, x) = XOR_{j in bits(x)} gf_mul(c, 1 << j)).

The coefficient matrix is a runtime input: its (rows, k, 8) bitplane
constants are a small device tensor, cached per matrix, and one kernel
build serves every encode and reconstruct matrix.

The encoder runs on the device it is given, "cuda" by default. With
device="cpu" every transform runs the kernel's plain PyTorch version;
that is how the tests hold the port against the JAX package on a host
without a GPU. Nothing falls back from the card to the CPU.
"""

from __future__ import annotations

import functools
import weakref
from contextlib import nullcontext

import numpy as np
import torch

from ..ops import gf256_mxu
from ..ops.gf256_cuda import (chain_streams, give_events, gf256_chain,
                               gf256_transform, piece_bounds, stage_pieces,
                               take_events)
from ..util import tracing
from . import gf


def resolve_device(device) -> torch.device:
    """torch.device for `device` (default "cuda"); raises when a CUDA
    device is asked for and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run the plain PyTorch version")
    return dev


@functools.lru_cache(maxsize=256)
def _device_consts(coeff_key: bytes, rows: int, k: int,
                   device: torch.device) -> torch.Tensor:
    coeff = np.frombuffer(coeff_key, dtype=np.uint8).reshape(rows, k)
    return torch.from_numpy(gf.bitplane_constants(coeff)).to(device)


def device_consts(coeff: np.ndarray, device: torch.device) -> torch.Tensor:
    """The (rows, k, 8) bitplane constants of a (rows, k) GF(256) matrix,
    as a uint8 tensor on `device` (cached per matrix; read-only)."""
    coeff = np.ascontiguousarray(coeff, dtype=np.uint8)
    rows, k = coeff.shape
    return _device_consts(coeff.tobytes(), rows, k, device)


def apply_consts(consts: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(..., k, n) -> (..., rows, n) through the kernel's (B, k, L) form."""
    *batch, k, n = data.shape
    out = gf256_transform(consts, data.reshape(-1, k, n))
    return out.reshape(*batch, consts.shape[0], n)


class TorchEncoder:
    """Drop-in for JaxEncoder with the math on a torch device.

    Accepts shard data shaped (k, n) or batched (..., k, n), as numpy
    arrays or uint8 tensors; returns tensors on the encoder's device.
    `parity_coeff` replaces the default RS(10,4) parity matrix."""

    def __init__(self, data_shards: int = gf.DATA_SHARDS,
                 parity_shards: int = gf.PARITY_SHARDS,
                 device=None, parity_coeff: np.ndarray | None = None):
        self.k = data_shards
        self.m = parity_shards
        self.n = data_shards + parity_shards
        self.device = resolve_device(device)
        if parity_coeff is None:
            parity_coeff = gf.parity_matrix(self.k, self.n)
        self.parity_coeff = np.array(parity_coeff, dtype=np.uint8)
        if self.parity_coeff.shape != (self.m, self.k):
            raise ValueError(f"parity_coeff must be ({self.m}, {self.k}), "
                             f"got {self.parity_coeff.shape}")

    def _tensor(self, a) -> torch.Tensor:
        """uint8 tensor on the encoder's device from an array, a tensor,
        or a list of equal-length rows of either."""
        if isinstance(a, (list, tuple)) and a \
                and isinstance(a[0], torch.Tensor):
            a = torch.stack([r.to(self.device) for r in a])
        if isinstance(a, torch.Tensor):
            if a.dtype != torch.uint8:
                raise TypeError(f"shard tensors must be uint8, got {a.dtype}")
            return a.to(self.device)
        arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint8))
        return torch.from_numpy(arr).to(self.device)

    def _apply(self, coeff: np.ndarray, data: torch.Tensor) -> torch.Tensor:
        return apply_consts(device_consts(coeff, self.device), data)

    # -- batched API (stripe-batch engine, ec/batch.py) -------------------

    def transform_batch(self, coeff: np.ndarray, block,
                        mxu: bool = False) -> torch.Tensor:
        """Apply a (rows, k) coefficient matrix to a (B, k, L) window
        block as ONE kernel launch -> (B, rows, L) on the device.

        With `mxu` the transform runs as a GF(2) bit-matrix product
        (ops/gf256_mxu.py, K4's port) instead of the nibble-table kernel
        (K1). On CUDA the launch is asynchronous; `transform_async` is
        the form that hands a host block in and reads the result back."""
        block = self._tensor(block)
        if block.dim() != 3:
            raise ValueError(f"block must be (B, k, L), got "
                             f"{tuple(block.shape)}")
        if mxu:
            return gf256_mxu.gf2_bitmatrix_transform(
                gf256_mxu.device_bitmatrix(coeff, self.device), block)
        return gf256_transform(device_consts(coeff, self.device), block)

    def transform_async(self, coeff: np.ndarray, block: np.ndarray,
                        mxu: bool = False):
        """Launch the transform of a host (B, k, L) block; returns a thunk
        yielding the (B, rows, L) numpy result.

        On CUDA the block is staged through a pinned host buffer, copied
        in and out with non_blocking copies on the current stream, and an
        event is recorded after the copy out. The thunk waits on that
        event only, so it may run on another thread while this one
        launches the next block. `mxu` is transform_batch's.

        Under a traced request the CUDA path records its host copies and
        pinned allocations as `ec.stage` spans, the two copy enqueues as
        `ec.h2d` and `ec.d2h`, and the thunk's wait as `ec.wait`."""
        card = self.device.type == "cuda"
        with tracing.start("ec", "stage") if card else nullcontext():
            block = np.ascontiguousarray(block, dtype=np.uint8)
        if not card:
            out = self.transform_batch(coeff, block, mxu)
            return lambda: out.numpy()
        stream = torch.cuda.current_stream(self.device)
        with tracing.start("ec", "stage"):
            staged = torch.from_numpy(block).pin_memory()
        with tracing.start("ec", "h2d"):
            dev_block = staged.to(self.device, non_blocking=True)
        out = self.transform_batch(coeff, dev_block, mxu)
        with tracing.start("ec", "stage"):
            host = torch.empty(out.shape, dtype=torch.uint8,
                               pin_memory=True)
        with tracing.start("ec", "d2h"):
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)

        # the default argument holds the pinned input until the thunk runs
        def thunk(_staged=staged):
            with tracing.start("ec", "wait"):
                done.synchronize()
                return host.numpy()

        return thunk

    def transform_chain_async(self, coeff: np.ndarray, buffers,
                              bounds: list[int] | None = None):
        """Launch the transform of one window, k equal-length host byte
        buffers, as one chain of pieces on the card (`gf256_chain`), so
        that K1 and the copy out of each piece run under the copy in of
        the next; returns a thunk yielding the (1, rows, L) numpy result.
        The pieces are `bounds`, piece_bounds(L) unless given; on the card
        the thunk's `pieces` is their number. Off the card it is
        transform_async of the stacked (1, k, L) block.

        The buffers are copied once, straight into a pinned buffer in the
        chain's piece-major layout (`stage_pieces`), an `ec.stage` span
        like the pinned output's allocation; the chain's one native call
        is the `ec.h2d` span and the thunk's wait `ec.wait`. The device
        buffers are allocated on the chain's stream A and marked as used
        on stream B; the pinned buffers and the events are held until the
        chain is done, by the thunk or, when it is dropped uncalled, by
        its finaliser."""
        if self.device.type != "cuda":
            return self.transform_async(coeff, np.stack(
                [np.asarray(b, np.uint8) for b in buffers])[None])
        k, length = len(buffers), len(buffers[0])
        consts = device_consts(coeff, self.device)
        rows = consts.shape[0]
        if bounds is None:
            bounds = piece_bounds(length)
        with tracing.start("ec", "stage"):
            staged = torch.empty(k * length, dtype=torch.uint8,
                                 pin_memory=True)
            stage_pieces(buffers, bounds, staged.numpy())
        with tracing.start("ec", "stage"):
            host = torch.empty((1, rows, length), dtype=torch.uint8,
                               pin_memory=True)
        streams = chain_streams(self.device)
        with torch.cuda.stream(streams[0]):
            dev_in = torch.empty(k * length, dtype=torch.uint8,
                                 device=self.device)
            dev_out = torch.empty((1, rows, length), dtype=torch.uint8,
                                  device=self.device)
        dev_in.record_stream(streams[1])
        dev_out.record_stream(streams[1])
        events = take_events(self.device)
        with tracing.start("ec", "h2d"):
            # this module's K1, so that a stand-in put in its place (an
            # instrumented or altered K1) runs in the chain too
            gf256_chain(consts, staged, dev_in, dev_out, host, bounds,
                        streams, events, transform=gf256_transform)

        def thunk():
            with tracing.start("ec", "wait"):
                finish()
                return host.numpy()

        finish = weakref.finalize(thunk, _chain_done, self.device, events,
                                  staged, host)
        finish.atexit = False
        thunk.pieces = len(bounds) - 1
        return thunk

    def encode_batch(self, block) -> torch.Tensor:
        """(B, k, L) data windows -> (B, k+m, L) full shard windows."""
        block = self._tensor(block)
        parity = self.transform_batch(self.parity_coeff, block)
        return torch.cat([block, parity], dim=1)

    def verify_batch(self, block) -> np.ndarray:
        """(B, k+m, L) stored windows -> (B,) bool verdicts; the parity
        recompute (one launch over the strided data rows) and the
        comparison both run on the device."""
        block = self._tensor(block)
        par = self.transform_batch(self.parity_coeff, block[:, :self.k, :])
        ok = (par == block[:, self.k:, :]).flatten(1).all(dim=1)
        return ok.cpu().numpy()

    def reconstruct_batch(self, present_rows: list[int],
                          want_rows: list[int], block) -> torch.Tensor:
        """Rebuild want_rows for every window of a (B, k, L) block of
        present shards (stacked in present_rows order) -> (B, r, L)."""
        coeff = gf.cached_shard_rows(tuple(want_rows),
                                     tuple(present_rows), self.k, self.n)
        return self.transform_batch(coeff, block)

    # -- per-stripe API ---------------------------------------------------

    def parity(self, data) -> torch.Tensor:
        """(..., k, n) data -> (..., m, n) parity."""
        return self._apply(self.parity_coeff, self._tensor(data))

    def encode(self, data) -> torch.Tensor:
        """(..., k, n) data -> (..., k+m, n) full shard set."""
        data = self._tensor(data)
        return torch.cat([data, self.parity(data)], dim=-2)

    def verify(self, shards) -> bool:
        """The unified backend verify: accepts a list of k+m equal-length
        rows OR a stacked (..., k+m, L) array."""
        shards = self._tensor(shards)
        par = self.parity(shards[..., :self.k, :])
        return bool(torch.equal(par, shards[..., self.k:, :]))

    def reconstruct_rows(self, present_rows: list[int], shards,
                         want_rows: list[int]) -> torch.Tensor:
        """Rebuild want_rows from the k rows listed in present_rows.

        shards: (..., k, n) — the present shards stacked in present_rows
        order. The (len(want), k) coefficient matrix is inverted on the
        host (tiny), like reedsolomon.Reconstruct before its matmul."""
        coeff = gf.shard_rows(list(want_rows), list(present_rows),
                              self.k, self.n)
        return self._apply(coeff, self._tensor(shards))

    def reconstruct(self, shards: list, data_only: bool = False) -> list:
        """List-of-(n,)-arrays-or-None API matching CpuEncoder.reconstruct;
        returns host numpy rows."""
        present = [i for i, s in enumerate(shards) if s is not None]
        missing = [i for i, s in enumerate(shards) if s is None]
        if len(present) < self.k:
            raise ValueError(
                f"too few shards to reconstruct: {len(present)} < {self.k}")
        if data_only:
            missing = [i for i in missing if i < self.k]
        out = [None if s is None else _host(s) for s in shards]
        if not missing:
            return out
        use = present[:self.k]
        stacked = self._tensor([self._tensor(shards[i]) for i in use])
        rebuilt = self.reconstruct_rows(use, stacked, missing).cpu().numpy()
        for row, idx in enumerate(missing):
            out[idx] = rebuilt[row]
        return out

    def reconstruct_data(self, shards: list) -> list:
        return self.reconstruct(shards, data_only=True)


def _chain_done(device: torch.device, events, *_buffers) -> None:
    """Wait for a chain, then give its events back; the buffers it used
    are released when this returns."""
    events.wait()
    give_events(device, events)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a, dtype=np.uint8)
