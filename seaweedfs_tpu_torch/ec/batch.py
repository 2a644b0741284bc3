"""Stripe-batch EC execution engine — one transform launch per B windows.

The port of seaweedfs_tpu/ec/batch.py, the shared engine of the bulk EC
paths — whole-volume encode (`pipeline.encode_volume`), parity verify
and whole-volume rebuild (`pipeline.rebuild_ec_files`):

* gather **B stripe windows into one `(B, k, L)` uint8 block**;
* run encode / verify / reconstruct as **ONE kernel launch per block**
  (`TorchEncoder.transform_async` / `verify_batch`: the kernel takes the
  batch axis with strides, so the block goes in as it is);
* account every dispatch, pread and byte **deterministically** (the
  `stats` dicts below), equal to the JAX package's counts for the same
  volume.

The GF(256) transform is independent per byte column, so batching is
exact: a `(B, k, L)` block transforms to the same bytes as B separate
`(k, L)` windows.
"""

from __future__ import annotations

import numpy as np

from . import gf
from .encoder_cpu import CpuEncoder
from .encoder_torch import TorchEncoder

# windows gathered per transform dispatch (the REQUESTED width; the
# resident-memory ceiling is clamp_batch_windows below)
DEFAULT_BATCH_WINDOWS = 8

# resident-byte ceiling for one gathered block: 8 x 14 rows x 1 MB
# windows (112 MB) fit, so the bulk paths' default 1 MB windows batch
# eight at a time; larger windows degrade toward one window per block
BLOCK_BYTE_BUDGET = 128 << 20


def clamp_batch_windows(batch_windows: int, window_bytes: int,
                        rows: int, budget: int | None = None) -> int:
    """Effective batch width: the requested window count bounded so one
    (B, rows, window_bytes) block stays inside the byte budget
    (always at least 1 — a single window must still fit)."""
    if batch_windows < 1:
        return 1
    if window_bytes <= 0 or rows <= 0:
        return batch_windows
    if budget is None:
        budget = BLOCK_BYTE_BUDGET
    return max(1, min(batch_windows, budget // (rows * window_bytes)))


def add_stat(stats: dict | None, **kv) -> None:
    """Accumulate deterministic accounting counters into an optional
    stats dict (windows / batches / dispatches / preads / bytes...)."""
    if stats is None:
        return
    for k, v in kv.items():
        stats[k] = stats.get(k, 0) + v


def transform_block(encoder, coeff: np.ndarray, block: np.ndarray,
                    stats: dict | None = None) -> np.ndarray:
    """Apply a (rows, k) GF(256) coefficient matrix to a (B, k, L)
    window block in ONE dispatch -> (B, rows, L) uint8."""
    return transform_block_async(encoder, coeff, block, stats)()


def transform_block_async(encoder, coeff: np.ndarray, block: np.ndarray,
                          stats: dict | None = None):
    """Launch the batched transform; returns a thunk yielding the
    (B, rows, L) numpy result. On CUDA the launch is asynchronous and
    the thunk waits on the stream event recorded after the copy back
    into a pinned host buffer, so the caller can overlap the NEXT
    block's preads with this block's device time. The host CpuEncoder
    computes eagerly and the thunk is a no-op, as in
    `pipeline._transform_buffers_async`; any other encoder raises
    TypeError."""
    block = np.asarray(block, np.uint8)
    add_stat(stats, dispatches=1, batches=1, windows=int(block.shape[0]),
             bytes_in=int(block.nbytes))
    if isinstance(encoder, CpuEncoder):
        out = encoder.transform_batch(coeff, block)
        return lambda: out
    if not isinstance(encoder, TorchEncoder):
        raise TypeError(f"the port's pipeline runs a TorchEncoder or a "
                        f"CpuEncoder, got {type(encoder).__name__}")
    return encoder.transform_async(coeff, block)


def verify_block(encoder, block: np.ndarray,
                 stats: dict | None = None) -> list[bool]:
    """Recompute parity for a (B, k+m, L) block and compare against its
    stored parity rows in ONE dispatch -> per-window verdicts.

    Zero-padded tail windows verify clean by construction: parity of
    all-zero data is all-zero, which is exactly what a shard read past
    EOF returns for the stored rows."""
    block = np.asarray(block, np.uint8)
    add_stat(stats, dispatches=1, batches=1, windows=int(block.shape[0]),
             bytes_in=int(block.nbytes))
    return [bool(ok) for ok in encoder.verify_batch(block)]


def localize_corrupt_rows(encoder, rows: np.ndarray) -> "list[int]":
    """Pin a corrupt stripe window's rot to ONE shard row, if possible.

    `rows` is a (total_shards, L) uint8 window whose parity check
    failed. For each hypothesis "shard c is the corrupt one", shard c
    is reconstructed from k of the OTHER rows and the whole window is
    re-verified with the reconstruction substituted: with a single
    corrupt row only the true culprit's hypothesis makes the stripe
    consistent. Returns [culprit] when exactly one hypothesis survives,
    [] when the window is ambiguous (multi-shard rot)."""
    from .pipeline import _transform_buffers

    total = int(rows.shape[0])
    k = gf.DATA_SHARDS
    culprits: "list[int]" = []
    for c in range(total):
        sources = [s for s in range(total) if s != c][:k]
        coeff = gf.cached_shard_rows((c,), tuple(sources))
        rec = _transform_buffers(encoder, coeff,
                                 [np.ascontiguousarray(rows[s])
                                  for s in sources])[0]
        cand = np.array(rows, np.uint8, copy=True)
        cand[c] = rec
        if bool(encoder.verify_batch(cand[None, :, :])[0]):
            culprits.append(c)
    return culprits if len(culprits) == 1 else []


def window_blocks(total_windows: int, batch_windows: int):
    """Yield (first_window_index, count) specs covering total_windows
    in ceil(total/batch) blocks — the dispatch-count contract."""
    if batch_windows < 1:
        batch_windows = 1
    wi = 0
    while wi < total_windows:
        count = min(batch_windows, total_windows - wi)
        yield wi, count
        wi += count
