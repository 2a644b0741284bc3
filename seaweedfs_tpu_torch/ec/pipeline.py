"""EC file pipelines: volume <-> 14 shard files, driven by the torch encoder.

The port of seaweedfs_tpu/ec/pipeline.py. Reference workflow
(ec_encoder.go):
  WriteEcFiles (:53)        .dat -> .ec00...ec13, streaming row batches
  WriteSortedFileFromIdx(:26) .idx -> .ecx sorted index
  RebuildEcFiles (:57)      regenerate missing shard files from >=10 present
  ec_decoder.go WriteDatFile(:150) shards -> .dat (ec.decode)

Each row batch is a host -> device copy through a pinned buffer and one
kernel launch: 1 MB windows gathered eight at a time by the stripe-batch
engine (ec/batch.py). On CUDA the launch is asynchronous, and reader and
writer threads overlap file I/O with the device work.

Every bulk transform here goes through a `TorchEncoder`. The one other
encoder `_transform_buffers` takes is the host `CpuEncoder`, which
EcVolume chooses for small degraded-read recovers; there is no silent
numpy path.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from contextlib import nullcontext

import numpy as np

from ..storage import types as t
from ..storage.needle_map import pack_entry, walk_index_blob, \
    write_sorted_index
from ..util import tracing
from . import gf
from .batch import (DEFAULT_BATCH_WINDOWS, add_stat, clamp_batch_windows,
                    transform_block_async, window_blocks)
from .encoder_cpu import CpuEncoder
from .encoder_torch import TorchEncoder
from .locate import LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, locate_data

# read-ahead / dispatch-ahead depth of the threaded encode pipeline: 2 is
# enough to overlap file reads, host<->device transfer + kernel time, and
# file writes (classic double buffering); more just holds memory
_PIPE_DEPTH = 2

# environment variable that pins get_encoder("auto"); separate from the
# JAX package's SWTPU_EC_BACKEND so both packages run in one process
BACKEND_ENV = "SWTPU_TORCH_EC_BACKEND"

# environment variable whose value "mxu" sends _transform_buffers_async
# through the GF(2) bit-matrix product (K4's port) instead of the
# nibble-table kernel; the port's name for the JAX package's
# SWTPU_EC_METHOD, kept apart for the same reason. It mirrors that option
# only: on the H100 the method gives the same bytes and is slower at every
# shape measured (PERF.md section 6), so leave it unset
METHOD_ENV = "SWTPU_TORCH_EC_METHOD"


def to_ext(shard_id: int) -> str:
    return ".ec%02d" % shard_id


def get_encoder(backend: str = "auto") -> TorchEncoder:
    """backend: 'gpu' | 'cpu' | 'auto' (= gpu).

    'auto' reads SWTPU_TORCH_EC_BACKEND first. 'gpu' (and so 'auto')
    raises when no CUDA device is available — it never degrades to the
    CPU. 'cpu' runs the kernel's plain PyTorch version on the host."""
    if backend == "auto":
        backend = os.environ.get(BACKEND_ENV, "auto").lower()
    if backend not in ("auto", "gpu", "cpu"):
        raise ValueError(
            f"unknown EC backend {backend!r}: use auto | gpu | cpu")
    # TorchEncoder raises for "cuda" when no CUDA device is available
    return TorchEncoder(device="cpu" if backend == "cpu" else "cuda")


def _transform_buffers_async(encoder, coeff: np.ndarray,
                             buffers: list[np.ndarray]):
    """Launch the GF transform of k equal-length host byte buffers and
    return a thunk that yields the output byte buffers when called.

    On CUDA a TorchEncoder stages the buffers into a pinned buffer and
    enqueues them as one chain of pieces on two streams
    (`transform_chain_async`); under SWTPU_TORCH_EC_METHOD "mxu", and on
    the CPU, it takes them as one (1, k, n) block through
    `transform_async`, the mxu method as a GF(2) bit-matrix product. On
    CUDA the thunk waits on the event recorded after the last copy back.
    The host CpuEncoder, which EcVolume picks for recovers under its
    small_recover_bytes, computes eagerly and the thunk is a no-op. Any
    other encoder raises TypeError. The thunk's `pieces` is the number of
    pieces the transform was enqueued in: the chain's, else 1."""
    if isinstance(encoder, CpuEncoder):
        out = encoder._apply(np.asarray(coeff, np.uint8),
                             [np.asarray(b, np.uint8) for b in buffers])
        return _launched(lambda: out, 1)
    if not isinstance(encoder, TorchEncoder):
        raise TypeError(f"the port's pipeline runs a TorchEncoder or a "
                        f"CpuEncoder, got {type(encoder).__name__}")
    mxu = os.environ.get(METHOD_ENV) == "mxu"
    if on_card(encoder) and not mxu:
        thunk = encoder.transform_chain_async(
            coeff, [np.asarray(b, np.uint8) for b in buffers])
        pieces = thunk.pieces
    else:
        # the host copy of a card recover's survivors, an `ec.stage` span
        with tracing.start("ec", "stage") if on_card(encoder) \
                else nullcontext():
            block = np.stack([np.asarray(b, np.uint8)
                              for b in buffers])[None]
        thunk = encoder.transform_async(coeff, block, mxu=mxu)
        pieces = 1
    return _launched(lambda: list(thunk()[0]), pieces)


def _launched(run, pieces: int):
    """`run`, with the pieces its transform was enqueued in as `pieces`."""
    run.pieces = pieces
    return run


def _transform_buffers(encoder, coeff: np.ndarray,
                       buffers: list[np.ndarray]) -> list[np.ndarray]:
    """Apply a GF coefficient matrix to equal-length host byte buffers."""
    return _transform_buffers_async(encoder, coeff, buffers)()


def _iter_row_batches(dat_size: int, large_block: int, small_block: int,
                      buffer_size: int):
    """Yield (start, block_size, buf_size, batch_index) specs covering the
    volume in row order (encodeData/encodeDataOneBatch split,
    ec_encoder.go:114-186)."""
    remaining = dat_size
    processed = 0
    large_row = large_block * gf.DATA_SHARDS
    while remaining > large_row:
        buf = min(buffer_size, large_block)
        assert large_block % buf == 0, (large_block, buf)
        for b in range(large_block // buf):
            yield processed, large_block, buf, b
        processed += large_row
        remaining -= large_row
    while remaining > 0:
        buf = min(buffer_size, small_block)
        assert small_block % buf == 0, (small_block, buf)
        for b in range(small_block // buf):
            yield processed, small_block, buf, b
        processed += small_block * gf.DATA_SHARDS
        remaining -= small_block * gf.DATA_SHARDS


def on_card(encoder) -> bool:
    """Whether `encoder` transforms on the card: a CUDA TorchEncoder,
    whose launch is asynchronous."""
    return isinstance(encoder, TorchEncoder) and \
        encoder.device.type == "cuda"


def _use_overlap(encoder) -> bool:
    """Thread overlap pays only when the launch is asynchronous: a CUDA
    TorchEncoder. On the CPU (the plain version, or the host CpuEncoder)
    the transform is eager, and the plain serial loop wins."""
    return on_card(encoder)


def _run_overlapped(read_batches, launch, write_result,
                    overlap: bool = True) -> None:
    """Three-stage threaded pipeline: a reader thread fills a bounded
    queue of input batches, the caller thread launches the (async) device
    transform, and a writer thread blocks on readback + file writes.
    Queue depth _PIPE_DEPTH bounds in-flight memory to ~2 batches.

    read_batches: generator yielding input batch objects.
    launch(batch) -> (batch, thunk) launched work.
    write_result(batch, thunk): called in writer-thread order.
    overlap=False degrades to the serial loop (CPU encoder).
    """
    if not overlap:
        for batch in read_batches:
            write_result(*launch(batch))
        return
    q_read: queue.Queue = queue.Queue(maxsize=_PIPE_DEPTH)
    q_write: queue.Queue = queue.Queue(maxsize=_PIPE_DEPTH)
    errs: list[BaseException] = []

    def reader() -> None:
        try:
            for batch in read_batches:
                if errs:
                    break
                q_read.put(batch)
        except BaseException as e:  # noqa: BLE001 — propagated below
            errs.append(e)
        finally:
            q_read.put(None)

    def writer() -> None:
        draining = False
        while True:
            item = q_write.get()
            if item is None:
                return
            if draining:
                continue
            try:
                write_result(*item)
            except BaseException as e:  # noqa: BLE001 — propagated below
                errs.append(e)
                draining = True  # keep consuming so the caller never blocks

    rt = threading.Thread(target=reader, daemon=True)
    wt = threading.Thread(target=writer, daemon=True)
    rt.start()
    wt.start()
    try:
        while True:
            batch = q_read.get()
            if batch is None:
                break
            if errs:
                continue  # drain reader output without launching more
            try:
                q_write.put(launch(batch))
            except BaseException as e:  # noqa: BLE001
                errs.append(e)
    finally:
        q_write.put(None)
        rt.join()
        wt.join()
    if errs:
        raise errs[0]


def encode_volume(base_name: str, encoder: TorchEncoder | None = None,
                  large_block: int = LARGE_BLOCK_SIZE,
                  small_block: int = SMALL_BLOCK_SIZE,
                  buffer_size: int = 1024 * 1024,
                  batch_windows: int = DEFAULT_BATCH_WINDOWS,
                  stats: dict | None = None) -> None:
    """Stripe <base>.dat into <base>.ec00 .. .ec13 (WriteEcFiles) with
    the stripe-batch engine: up to `batch_windows` stripe windows
    gather into one (B, 10, buf) block and ONE kernel launch emits all
    four parity rows for every window in the block — ceil(W/B)
    launches per uniform-window run instead of W. Groups flush once at
    the large->small block-size boundary (mixed window lengths never
    share a block).

    Windows whose preads are contiguous in the .dat coalesce into one
    read per shard position. File I/O overlaps the device transform via
    the double-buffered reader/writer threads (`_run_overlapped`);
    `stats` accumulates windows/batches/dispatches/preads/bytes."""
    encoder = encoder or get_encoder()
    parity = gf.parity_matrix()
    dat_path = base_name + ".dat"
    dat_size = os.path.getsize(dat_path)
    outs = [open(base_name + to_ext(i), "wb") for i in range(gf.TOTAL_SHARDS)]
    f = open(dat_path, "rb")

    def groups():
        pending: list[tuple] = []
        limit = 1
        for spec in _iter_row_batches(dat_size, large_block, small_block,
                                      buffer_size):
            if pending and (spec[2] != pending[0][2]
                            or len(pending) >= limit):
                yield pending
                pending = []
            if not pending:
                # resident budget: data rows + parity rows per window
                limit = clamp_batch_windows(batch_windows, spec[2],
                                            gf.TOTAL_SHARDS)
            pending.append(spec)
        if pending:
            yield pending

    def read_block(group):
        """One (B, 10, buf) block read straight into its final array;
        contiguous window reads coalesce into single preads per shard
        position."""
        buf = group[0][2]
        block = np.empty((len(group), gf.DATA_SHARDS, buf), np.uint8)
        preads = 0
        for i in range(gf.DATA_SHARDS):
            runs: list[list[int]] = []
            for start, bs, _, b in group:
                off = start + bs * i + b * buf
                if runs and off == runs[-1][0] + runs[-1][1]:
                    runs[-1][1] += buf
                else:
                    runs.append([off, buf])
            w = 0
            for off, ln in runs:
                f.seek(off)
                raw = f.read(ln)
                if len(raw) < ln:
                    raw += b"\x00" * (ln - len(raw))
                n = ln // buf
                block[w:w + n, i, :] = np.frombuffer(
                    raw, np.uint8).reshape(n, buf)
                w += n
            preads += len(runs)
        return block, preads

    def batches():
        for group in groups():
            yield read_block(group)

    def launch(item):
        block, preads = item
        add_stat(stats, preads=preads, bytes_read=int(block.nbytes))
        return item, transform_block_async(encoder, parity, block, stats)

    def write_result(item, thunk):
        block, _ = item
        parities = thunk()      # (B, m, buf)
        for i in range(gf.DATA_SHARDS):
            outs[i].write(np.ascontiguousarray(block[:, i, :]).tobytes())
        for p in range(gf.PARITY_SHARDS):
            outs[gf.DATA_SHARDS + p].write(
                np.ascontiguousarray(parities[:, p, :]).tobytes())

    try:
        _run_overlapped(batches(), launch, write_result,
                        overlap=_use_overlap(encoder))
    finally:
        f.close()
        for o in outs:
            o.close()


def write_ec_files(base_name: str, encoder: TorchEncoder | None = None,
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   buffer_size: int = 1024 * 1024,
                   batch_windows: int = DEFAULT_BATCH_WINDOWS,
                   stats: dict | None = None) -> None:
    """Historical name for `encode_volume` (WriteEcFiles) — same
    batched engine, byte-identical shard files at any batch size."""
    encode_volume(base_name, encoder=encoder, large_block=large_block,
                  small_block=small_block, buffer_size=buffer_size,
                  batch_windows=batch_windows, stats=stats)


def write_ec_files_batched(base_names: list[str],
                           encoder: TorchEncoder | None = None,
                           large_block: int = LARGE_BLOCK_SIZE,
                           small_block: int = SMALL_BLOCK_SIZE,
                           buffer_size: int = 8 * 1024 * 1024,
                           batch_volumes: int = 8) -> None:
    """Stripe SEVERAL volumes' .dat files with batched kernel launches —
    the rack-encode configuration (reference encodes volumes serially,
    command_ec_encode.go:89).

    The GF transform is independent per byte column, so equal-length
    buffer groups from DIFFERENT volumes concatenate into one stream per
    shard position: one kernel launch then carries up to
    batch_volumes x 10 x buffer_size bytes.

    Parity buffers surface in flush order, not stream order, so every
    parity write lands at an explicitly recorded shard offset.
    """
    import collections

    encoder = encoder or get_encoder()
    parity = gf.parity_matrix()
    outs: dict[str, list] = {}
    # buf_len -> list of (data_buffers, base, parity_shard_offset)
    pending: dict[int, list] = {}
    pending_refs: dict[str, int] = {}   # base -> unflushed group count
    fully_enqueued: set[str] = set()
    # launched-but-unwritten kernel batches: lets the next group's file
    # reads overlap this group's device time (dispatch-ahead)
    inflight: collections.deque = collections.deque()

    def maybe_close(base: str) -> None:
        # bound open fds: at most batch_volumes in-flight volumes keep
        # their 14 shard files open
        if base in fully_enqueued and pending_refs.get(base, 0) == 0:
            for f in outs.pop(base, []):
                f.close()

    def drain_one() -> None:
        group, thunk = inflight.popleft()
        parities = thunk()
        off = 0
        for buffers, base, shard_off in group:
            ln = len(buffers[0])
            for p, pbuf in enumerate(parities):
                f = outs[base][gf.DATA_SHARDS + p]
                f.seek(shard_off)
                f.write(np.asarray(pbuf[off:off + ln], np.uint8).tobytes())
            off += ln
            pending_refs[base] -= 1
            maybe_close(base)

    def flush(buf_len: int) -> None:
        group = pending.pop(buf_len, [])
        if not group:
            return
        cat = [np.concatenate([g[0][i] for g in group])
               if len(group) > 1 else group[0][0][i]
               for i in range(gf.DATA_SHARDS)]
        inflight.append(
            (group, _transform_buffers_async(encoder, parity, cat)))
        while len(inflight) > _PIPE_DEPTH:
            drain_one()

    try:
        for base in base_names:
            dat_path = base + ".dat"
            dat_size = os.path.getsize(dat_path)
            outs[base] = [open(base + to_ext(i), "wb")
                          for i in range(gf.TOTAL_SHARDS)]
            shard_pos = 0
            with open(dat_path, "rb") as f:
                for start, block_size, buf, b in _iter_row_batches(
                        dat_size, large_block, small_block, buffer_size):
                    buffers = []
                    for i in range(gf.DATA_SHARDS):
                        f.seek(start + block_size * i + b * buf)
                        raw = f.read(buf)
                        if len(raw) < buf:
                            raw += b"\x00" * (buf - len(raw))
                        buffers.append(np.frombuffer(raw, np.uint8))
                        outs[base][i].write(raw)
                    pending.setdefault(buf, []).append(
                        (buffers, base, shard_pos))
                    pending_refs[base] = pending_refs.get(base, 0) + 1
                    shard_pos += buf
                    if len(pending[buf]) >= batch_volumes:
                        flush(buf)
            fully_enqueued.add(base)
            maybe_close(base)
        for buf_len in list(pending):
            flush(buf_len)
        while inflight:
            drain_one()
    finally:
        for fs in outs.values():
            for f in fs:
                f.close()


def write_sorted_file_from_idx(base_name: str,
                               ext: str = ".ecx") -> None:
    """<base>.idx -> sorted <base>.ecx (WriteSortedFileFromIdx,
    ec_encoder.go:26-50). Tombstoned entries keep TOMBSTONE size."""
    with open(base_name + ".idx", "rb") as f:
        blob = f.read()
    entries = list(walk_index_blob(blob))
    write_sorted_index(entries, base_name + ext)


def present_shards(base_name: str) -> list[int]:
    return [i for i in range(gf.TOTAL_SHARDS)
            if os.path.exists(base_name + to_ext(i))]


class RebuildRotError(ValueError):
    """A rebuild input disagreed with the others in some window and no
    single shard could be pinned as the rotten one: nothing was
    written."""


def _needle_spans(base_name: str, shard_size: int, large_block: int,
                  small_block: int) -> "list[tuple[int, list]]":
    """(needle id, [(shard, shard offset, size), ...]) of every live
    needle in <base>.ecx, located as EcVolume.read_needle locates it;
    [] without an .ecx."""
    if not os.path.exists(base_name + ".ecx"):
        return []
    with open(base_name + ".ecx", "rb") as f:
        blob = f.read()
    dat_size = gf.DATA_SHARDS * shard_size
    out = []
    for key, off, size in walk_index_blob(blob):
        if size <= 0 or size == t.TOMBSTONE_FILE_SIZE:
            continue
        ivs = locate_data(large_block, small_block, dat_size, off,
                          t.actual_size(size, t.CURRENT_VERSION))
        out.append((key, [iv.to_shard_and_offset(large_block, small_block)
                          + (iv.size,) for iv in ivs]))
    return out


def _pread(path_or_fd, offset: int, size: int) -> bytes:
    fd = path_or_fd if isinstance(path_or_fd, int) else None
    if fd is None:
        with open(path_or_fd, "rb") as f:
            return _pread(f.fileno(), offset, size)
    raw = os.pread(fd, size, offset)
    return raw + b"\x00" * (size - len(raw))


def _overlaps(spans: list, lo: int, hi: int) -> bool:
    return any(soff < hi and soff + n > lo for _sid, soff, n in spans)


def _needles_pass(base_name: str, needles: list, pos: int, size: int,
                  rows: "dict[int, np.ndarray]", targets: list,
                  outs: list, unsettled: list) -> "bool | None":
    """Whether every needle with bytes in data rows [pos, pos + size)
    parses and passes its CRC when the window's data rows are `rows`;
    None when no needle there can be checked. A needle's bytes outside
    the window come from the rebuilt target files (`outs`) or the shard
    files on disk; one with bytes on neither, or in another window still
    `unsettled` ((lo, hi) shard offsets whose target bytes are not yet
    known), is not checked."""
    from ..storage.needle import Needle, NeedleError
    seen = False
    for key, spans in needles:
        if not _overlaps(spans, pos, pos + size) or any(
                _overlaps(spans, lo, hi) for lo, hi in unsettled):
            continue
        parts = []
        for sid, soff, n in spans:
            a, b = max(soff, pos), min(soff + n, pos + size)
            if a <= soff and soff + n <= b:
                parts.append(rows[sid][soff - pos:soff + n - pos].tobytes())
                continue
            if sid in targets:
                src = outs[targets.index(sid)].fileno()
            elif os.path.exists(base_name + to_ext(sid)):
                src = base_name + to_ext(sid)
            else:
                break
            if a >= b:
                parts.append(_pread(src, soff, n))
                continue
            parts.append(_pread(src, soff, a - soff)
                         + rows[sid][a - pos:b - pos].tobytes()
                         + _pread(src, b, soff + n - b))
        else:
            seen = True
            try:
                got = Needle.from_bytes(b"".join(parts), t.CURRENT_VERSION)
            except (NeedleError, IndexError, ValueError):
                return False
            if got.id != key:
                return False
    return True if seen else None


def _pin_window(base_name: str, encoder, targets: list, use: list,
                pos: int, size: int, needles: list, outs: list,
                unsettled: list, stats: dict | None
                ) -> "tuple[int, np.ndarray] | None":
    """The one rotten input of a window whose check rows disagreed, and
    the target rows regenerated without it; None when not exactly one
    input can be pinned. Each hypothesis is one launch, counted in
    `stats` as pin_launches (apart from the pass's launches).

    Hypothesis c decodes the targets and the window's other data rows
    from the first k of the other inputs, in one launch. With k + 2 or
    more inputs it also derives the rest of them and must match what
    was read (as batch.localize_corrupt_rows does over a whole stripe);
    the needles that cross the window in the data rows must then pass
    their CRCs where any can be checked. With k + 1 every hypothesis is
    consistent, and the needle CRCs alone decide."""
    k = gf.DATA_SHARDS
    rows = {s: np.frombuffer(_pread(base_name + to_ext(s), pos, size),
                             np.uint8) for s in use}
    found = []
    for c in use:
        others = [s for s in use if s != c]
        src, chk = others[:k], others[k:]
        need = list(targets) + chk
        need += [d for d in range(k) if d not in src and d not in need]
        coeff = gf.cached_shard_rows(tuple(need), tuple(src))
        add_stat(stats, pin_launches=1)
        out = transform_block_async(
            encoder, coeff, np.stack([rows[s] for s in src])[None])()[0]
        if not all(np.array_equal(out[len(targets) + j], rows[s])
                   for j, s in enumerate(chk)):
            continue
        data = {s: rows[s] for s in src if s < k}
        data.update({d: out[j] for j, d in enumerate(need) if d < k})
        # the needle CRCs decide where no check row can (k + 1), and
        # veto a check-row verdict they contradict: two rotten inputs
        # can agree on a check row and pose as one
        verdict = _needles_pass(base_name, needles, pos, size, data,
                                targets, outs, unsettled)
        if verdict is False or (verdict is None and not chk):
            continue
        found.append((c, np.asarray(out[:len(targets)], np.uint8)))
    return found[0] if len(found) == 1 else None


def _rebuild_rows(base_name: str, encoder: TorchEncoder, targets: list[int],
                  use: list[int], buffer_size: int,
                  stats: dict | None,
                  batch_windows: int = DEFAULT_BATCH_WINDOWS,
                  large_block: int = LARGE_BLOCK_SIZE,
                  small_block: int = SMALL_BLOCK_SIZE,
                  rot_found: "list | None" = None) -> None:
    """Regenerate the `targets` shard files from the `use` shards
    through the stripe-batch engine: up to `batch_windows` buffer
    windows gather into one (B, k, buf) block read with ONE pread per
    survivor, and ONE kernel launch emits ALL target rows for every
    window in the block (len(targets) x k coefficients) — ceil(W/B)
    launches per rebuild instead of W.

    Inputs past the first k are check rows: the same launch derives
    them from the first k ((len(targets) + extras) x k coefficients)
    and each window compares them with what was read. A window that
    disagrees is pinned to one rotten input (_pin_window) and
    regenerated without it, and the culprit is appended to `rot_found`;
    where none can be pinned, RebuildRotError. With exactly k inputs
    there is nothing to check against, and the targets are whatever
    the k inputs give. The targets are written to `.rebuild` files and
    renamed only once every window is settled, so a refused rebuild
    writes no shard."""
    k = gf.DATA_SHARDS
    src, extras = use[:k], use[k:]
    coeff = gf.cached_shard_rows(tuple(targets) + tuple(extras), tuple(src))
    shard_size = os.path.getsize(base_name + to_ext(use[0]))
    ins = [open(base_name + to_ext(i), "rb") for i in use]
    tmp = [base_name + to_ext(i) + ".rebuild" for i in targets]
    outs = [open(p, "w+b") for p in tmp]
    n_windows = -(-shard_size // buffer_size) if shard_size else 0
    # resident budget: survivor rows in + target rows out per window
    batch_windows = clamp_batch_windows(batch_windows, buffer_size,
                                        len(use) + len(targets))
    bad: list[int] = []

    def batches():
        for wi, count in window_blocks(n_windows, batch_windows):
            pos = wi * buffer_size
            take = min(count * buffer_size, shard_size - pos)
            rows = []
            for f in ins:
                f.seek(pos)
                raw = f.read(take)
                # zero-pad the tail to whole windows: GF of zero rows
                # is zero, and the pad is sliced off before writing
                if len(raw) < count * buffer_size:
                    raw += b"\x00" * (count * buffer_size - len(raw))
                rows.append(np.frombuffer(raw, np.uint8
                                          ).reshape(count, buffer_size))
            add_stat(stats, preads=len(ins), bytes_read=take * len(ins))
            yield (wi, np.stack(rows[:k], axis=1),
                   np.stack(rows[k:], axis=1) if extras else None, take)

    def launch(item):
        add_stat(stats, launches=1)
        return item, transform_block_async(encoder, coeff, item[1], stats)

    def write_result(item, thunk):
        wi, _, check, take = item
        rebuilt = thunk()       # (B, targets + extras, buf)
        if check is not None:
            for b in range(check.shape[0]):
                if not np.array_equal(rebuilt[b, len(targets):], check[b]):
                    bad.append(wi + b)
        for j, o in enumerate(outs):
            out = np.ascontiguousarray(rebuilt[:, j, :]
                                       ).tobytes()[:take]
            add_stat(stats, bytes_rebuilt=len(out))
            o.write(out)

    done = False
    try:
        _run_overlapped(batches(), launch, write_result,
                        overlap=_use_overlap(encoder))
        if bad:
            for o in outs:
                o.flush()
            needles = _needle_spans(base_name, shard_size, large_block,
                                    small_block)
            add_stat(stats, rot_windows=len(bad))
            # windows in order; one a needle ties to a window not yet
            # settled gets another pass once that one is
            pending, found = list(bad), {}
            while pending:
                settled = 0
                for wi in list(pending):
                    pos = wi * buffer_size
                    size = min(buffer_size, shard_size - pos)
                    unsettled = [(w * buffer_size, (w + 1) * buffer_size)
                                 for w in pending if w != wi]
                    pinned = _pin_window(base_name, encoder, targets, use,
                                         pos, size, needles, outs,
                                         unsettled, stats)
                    if pinned is None:
                        continue
                    c, fixed = pinned
                    for j, o in enumerate(outs):
                        os.pwrite(o.fileno(), fixed[j].tobytes()[:size], pos)
                    found[wi] = {"window": wi, "offset": pos, "size": size,
                                 "shards": [c], "found_by": "rebuild"}
                    pending.remove(wi)
                    settled += 1
                if pending and not settled:
                    raise RebuildRotError(
                        f"rebuild inputs {use} disagree in window "
                        f"{pending[0]} (shard offset "
                        f"{pending[0] * buffer_size}) and no single input "
                        f"can be pinned as the rotten one")
            if rot_found is not None:
                rot_found.extend(found[w] for w in sorted(found))
        done = True
    finally:
        for f in ins:
            f.close()
        for o in outs:
            o.close()
        for p in tmp:
            if done:
                os.replace(p, p[:-len(".rebuild")])
            elif os.path.exists(p):
                os.remove(p)


def rebuild_ec_files(base_name: str, encoder: TorchEncoder | None = None,
                     buffer_size: int = 1024 * 1024,
                     sequential: bool = False,
                     stats: dict | None = None,
                     batch_windows: int = DEFAULT_BATCH_WINDOWS,
                     targets: "list[int] | None" = None,
                     use: "list[int] | None" = None,
                     large_block: int = LARGE_BLOCK_SIZE,
                     small_block: int = SMALL_BLOCK_SIZE,
                     rot_found: "list | None" = None) -> list[int]:
    """Regenerate missing shard files from >=10 present ones
    (RebuildEcFiles -> rebuildEcFiles, ec_encoder.go:227-281).
    Returns the rebuilt shard ids.

    Default is the stripe-batched whole-volume rebuild: ALL missing
    shards come out of one coefficient-matrix launch per
    `batch_windows`-window block, and the survivors are read ONCE.
    `sequential=True` keeps the per-shard shape (one full pass of
    survivor reads + one launch per window PER lost shard); `stats`
    accumulates bytes_read / bytes_rebuilt / launches / dispatches /
    preads / windows / seconds.

    `targets` restricts WHICH absent shards are regenerated; `use`
    restricts WHICH present shards feed the reconstruction. None keeps
    the rebuild-everything and all-on-disk defaults. Of the inputs,
    the first k + gf.REBUILD_CHECK_ROWS are read: k to decode from and
    the rest to check them (_rebuild_rows), so a rotten input is
    pinned and left out (and appended to `rot_found`, with the window
    it was found in) or the rebuild is refused with RebuildRotError. The
    needle CRCs that decide between inputs where only one check row
    exists are located with `large_block`/`small_block`. With exactly
    k inputs nothing is checked."""
    encoder = encoder or get_encoder()
    have = present_shards(base_name)
    missing = [i for i in range(gf.TOTAL_SHARDS) if i not in have]
    if targets is not None:
        absent = set(missing)
        bad = [t for t in targets if t not in absent]
        if bad:
            raise ValueError(
                f"rebuild targets {bad} already present on disk")
        missing = sorted(set(targets))
    if not missing:
        return []
    if use is not None:
        absent_use = [s for s in use if s not in have]
        if absent_use:
            raise ValueError(
                f"rebuild inputs {absent_use} not present on disk")
        have = sorted(set(use))
    if len(have) < gf.DATA_SHARDS:
        raise ValueError(
            f"unrepairable: only {len(have)} shards present, "
            f"need {gf.DATA_SHARDS}")
    use = have[:gf.DATA_SHARDS + gf.REBUILD_CHECK_ROWS]
    t0 = time.perf_counter()
    blocks = {"large_block": large_block, "small_block": small_block,
              "rot_found": rot_found}
    if sequential:
        for target in missing:
            _rebuild_rows(base_name, encoder, [target], use,
                          buffer_size, stats, batch_windows=1, **blocks)
    else:
        _rebuild_rows(base_name, encoder, missing, use,
                      buffer_size, stats, batch_windows=batch_windows,
                      **blocks)
    if stats is not None:
        stats["seconds"] = stats.get("seconds", 0.0) + \
            (time.perf_counter() - t0)
        stats["rebuilt"] = missing
    return missing


def write_dat_file(base_name: str, dat_size: int,
                   large_block: int = LARGE_BLOCK_SIZE,
                   small_block: int = SMALL_BLOCK_SIZE,
                   buffer_size: int = 8 * 1024 * 1024) -> None:
    """Reassemble <base>.dat from the 10 data shard files (ec.decode;
    ec_decoder.go:150-191)."""
    ins = []
    try:
        for i in range(gf.DATA_SHARDS):
            path = base_name + to_ext(i)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"data shard {i} missing; rebuild first: {path}")
            ins.append(open(path, "rb"))
        with open(base_name + ".dat", "wb") as out:
            pos = 0
            while pos < dat_size:
                take = min(buffer_size, dat_size - pos)
                for iv in locate_data(large_block, small_block, dat_size,
                                      pos, take):
                    sid, soff = iv.to_shard_and_offset(large_block,
                                                       small_block)
                    ins[sid].seek(soff)
                    out.write(ins[sid].read(iv.size))
                pos += take
    finally:
        for f in ins:
            f.close()


def write_idx_file_from_ec_index(base_name: str) -> None:
    """<base>.ecx (+ .ecj tombstone replay) -> <base>.idx
    (WriteIdxFileFromEcIndex, ec_decoder.go:17-42). Entries copy over
    as-is, with tombstoned ones rewritten to offset 0 (the reassembled
    .dat is truncated to the live extent); any .ecj keys are appended
    as delete entries so the rebuilt needle map agrees with the EC
    delete journal."""
    with open(base_name + ".ecx", "rb") as f:
        entries = [(key, 0 if size == t.TOMBSTONE_FILE_SIZE else off, size)
                   for key, off, size in walk_index_blob(f.read())]
    ecj_path = base_name + ".ecj"
    if os.path.exists(ecj_path):
        with open(ecj_path, "rb") as f:
            j = f.read()
        for i in range(len(j) // 8):
            key = int.from_bytes(j[i * 8:(i + 1) * 8], "big")
            entries.append((key, 0, t.TOMBSTONE_FILE_SIZE))
    with open(base_name + ".idx", "wb") as f:
        for key, off, size in entries:
            f.write(pack_entry(key, off, size))


def find_dat_file_size(base_name: str,
                       version: int = t.CURRENT_VERSION) -> int:
    """Logical volume size from the .ecx index (FindDatFileSize,
    ec_decoder.go:47-69): max(offset + record length) over entries."""
    size = 8  # superblock
    with open(base_name + ".ecx", "rb") as f:
        blob = f.read()
    for key, off, esize in walk_index_blob(blob):
        if esize == t.TOMBSTONE_FILE_SIZE:
            continue
        end = off + t.actual_size(esize, version)
        size = max(size, end)
    return size
