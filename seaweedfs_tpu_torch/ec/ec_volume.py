"""EC volume: serve needle reads from shard files, with degraded-read
reconstruction when shards are missing.

Reference: ec_volume.go:24-72 (open .ecx/.ecj + shards),
ec_volume.go:183-228 (LocateEcShardNeedle + sorted-index search),
ec_shard.go:87-91 (shard ReadAt), store_ec.go:119-209 (interval gather,
local -> remote -> recover fallback), ec_volume_delete.go (tombstone in
.ecx + .ecj journal).

This class covers the local/in-process part; the volume server layer adds
the remote-shard gRPC-analog fetch. `fetch_remote` is the injection point:
fn(shard_id, offset, size) -> bytes | None.

The port of seaweedfs_tpu/ec/ec_volume.py. A recover transform of at
least `small_recover_bytes` and every parity verify run on the port's
`get_encoder()`, which means the CUDA kernel unless the caller or
SWTPU_TORCH_EC_BACKEND=cpu says otherwise; smaller recovers run on the
host `CpuEncoder`, as in the JAX package. A kernel that fails to build
or launch fails the read: nothing re-runs it on the host.
"""

from __future__ import annotations

import os

import threading
from contextlib import contextmanager
from typing import Callable

from ..storage import types as t
from ..storage.needle import CrcMismatch, Needle, NeedleError
from ..storage.needle_map import SortedFileNeedleMap
from ..util import failpoints, glog, tracing
from . import gf
from .locate import (LARGE_BLOCK_SIZE, SMALL_BLOCK_SIZE, Interval,
                     locate_data)
from .pipeline import (get_encoder, on_card, to_ext, _transform_buffers,
                       _transform_buffers_async)

import numpy as np


def _count_recover(path: str, rows: int, pieces: int) -> None:
    """SeaweedFS_ec_recovers_total, SeaweedFS_ec_recover_rows_total and
    SeaweedFS_ec_recover_pieces_total, by the path the transform took:
    over the recovers, rows and pieces per recover."""
    from ..stats import metrics
    if metrics.HAVE_PROMETHEUS:
        metrics.EC_RECOVERS.labels(path).inc()
        metrics.EC_RECOVER_ROWS.labels(path).inc(rows)
        metrics.EC_RECOVER_PIECES.labels(path).inc(pieces)


class EcVolumeError(Exception):
    pass


class NotFoundError(EcVolumeError):
    pass


# the stripe window a found-rot report names (the scrubber's default
# window): a read that pins rot to one shard reports it in the
# scrubber's structured form, with window = offset // REPORT_WINDOW
REPORT_WINDOW = 1 << 20


class RepairPlan:
    """Survivor preference order for reconstructing lost shards of one
    (vid, missing-set): local rows first (free), then remote rows
    grouped so the batch gather touches as few holders as possible.

    The plan holds the ORDER only — which of the remote rows are
    actually fetched is decided per interval, after cached survivor
    bytes are consumed — so one plan serves every offset. Cached per
    missing-set on the EcVolume and invalidated on shard
    mount/unmount (and on a holder-map refresh, which can regroup the
    remote rows)."""

    __slots__ = ("local", "remote")

    def __init__(self, local: list[int], remote: list[int]):
        self.local = local
        self.remote = remote


def order_holder_groups(groups: dict) -> list[int]:
    """Remote-row preference order from {holder_key: [sids]}: largest
    holder groups first (the batch gather costs the fewest round trips
    for the bytes that must move), unknown-holder rows (None key)
    last, sids ascending within a group. THE shared ordering — both
    select_survivors and EcVolume._repair_plan build their remote tail
    through it, so the spec'd selection and the shipped plan cannot
    drift."""
    ordered = sorted(((sorted(g), key) for key, g in groups.items()),
                     key=lambda t: (t[1] is None, -len(t[0]),
                                    t[0][0] if t[0] else -1))
    return [sid for g, _ in ordered for sid in g]


def select_survivors(want_sid: int, local, cached=(), remote_groups=(),
                     k: int = gf.DATA_SHARDS) -> list[int]:
    """Choose exactly k survivor rows for reconstructing `want_sid`,
    cheapest bytes first (arxiv 2306.10528's selection step):

      1. local shards — zero bytes moved;
      2. cached survivor intervals — bytes already moved once, reused;
      3. remote shards, holder groups largest-first — the batch gather
         then costs the fewest round trips for the bytes it must move.

    remote_groups: iterable of sid groups, one per holder (a bare
    iterable of sids counts as one group each). Deterministic; raises
    EcVolumeError when fewer than k distinct survivors exist."""
    chosen: list[int] = []
    seen = {want_sid}

    def take(sids) -> bool:
        for sid in sids:
            if sid in seen:
                continue
            seen.add(sid)
            chosen.append(sid)
            if len(chosen) == k:
                return True
        return False

    groups = {i: (sorted(g) if isinstance(g, (list, tuple, set,
                                              frozenset)) else [g])
              for i, g in enumerate(remote_groups)}
    if take(sorted(local)) or take(sorted(cached)) \
            or take(order_holder_groups(groups)):
        return chosen
    raise EcVolumeError(
        f"cannot plan recovery of shard {want_sid}: only "
        f"{len(chosen)} survivors available, need {k}")


class EcVolume:
    def __init__(self, dirname: str, collection: str, vid: int,
                 version: int = t.CURRENT_VERSION,
                 large_block: int = LARGE_BLOCK_SIZE,
                 small_block: int = SMALL_BLOCK_SIZE,
                 encoder=None,
                 fetch_remote: Callable[[int, int, int], bytes | None] | None = None,
                 fetch_remote_batch=None,
                 recover_cache=None,
                 holder_peek=None,
                 refresh_holders=None,
                 small_recover_bytes: int | None = None,
                 report_rot: Callable[[dict], None] | None = None):
        self.dir = dirname
        self.collection = collection
        self.vid = vid
        # degraded-read reconstruction cache (util/chunk_cache
        # LruByteCache, usually shared store-wide): keys carry the vid
        # so one cache serves every mounted EC volume. Shard bytes are
        # immutable once written (deletes tombstone the .ecx, never the
        # shards), so entries only go stale when shards are re-encoded
        # — the Store drops this vid's keys on EC mount/unmount.
        self._recover_cache = recover_cache
        self.version = version
        self.large_block = large_block
        self.small_block = small_block
        self._encoder = encoder
        self._default_encoder = None
        self._small_encoder = None
        self.fetch_remote = fetch_remote
        # batched form: fn([(sid, off, size), ...]) -> dict[sid, bytes]
        # | None — one request per remote HOLDER instead of one per
        # shard interval (the recover gather's network fan-out)
        self.fetch_remote_batch = fetch_remote_batch
        # repair planning hooks (volume server): holder_peek() returns
        # {sid: holder_key} for NON-local shards from the location
        # cache without any I/O (grouping remote rows by holder);
        # refresh_holders() forces one holder-map re-resolve after a
        # failed batch gather
        self.holder_peek = holder_peek
        self.refresh_holders = refresh_holders
        # device-vs-host recover crossover (-ec.smallrecover): below
        # this, a recover transform is dispatch-latency-bound and the
        # host path wins; chip_smoke.py phase 7 measures the crossover
        # on the card
        self.small_recover_bytes = (self.SMALL_RECOVER_BYTES
                                    if small_recover_bytes is None
                                    else int(small_recover_bytes))
        # per-(missing-set) repair plans; invalidated on shard
        # mount/unmount and holder-map refresh
        self._plans: dict[frozenset, RepairPlan] = {}
        # fn(report) for a survivor a read pinned as rotten, in the
        # scrubber's structured form (the Store forwards it to the
        # volume server's scrubber, where the autopilot observes it)
        self.report_rot = report_rot
        # reads whose needle failed its CRC and were decoded again with
        # one survivor left out at a time (_reread_without_culprit)
        self.rereads = 0
        base = collection + "_" + str(vid) if collection else str(vid)
        self.base_name = os.path.join(dirname, base)
        self._ecx = SortedFileNeedleMap(self.base_name + ".ecx",
                                        writable=True)
        self._ecj = open(self.base_name + ".ecj", "ab")
        self._lock = threading.RLock()
        # read_needle's row groups on the thread that reads
        # (_recover_interval_src)
        self._rows = threading.local()
        self.shards: dict[int, object] = {}
        for sid in range(gf.TOTAL_SHARDS):
            p = self.base_name + to_ext(sid)
            if os.path.exists(p):
                self.shards[sid] = open(p, "rb")

    # ---- index ----

    def find_needle(self, needle_id: int) -> tuple[int, int]:
        """Binary search .ecx -> (offset, size incl. tombstones); raises
        NotFoundError (SearchNeedleFromSortedIndex, ec_volume.go:203-228)."""
        raw = self._ecx.get_raw(needle_id)
        if raw is None:
            raise NotFoundError(f"needle {needle_id:x} not in ecx")
        return raw

    def delete_needle(self, needle_id: int) -> None:
        """Mark deleted in .ecx + journal to .ecj
        (DeleteNeedleFromEcx, ec_volume_delete.go:27-49)."""
        with self._lock:
            if self._ecx.mark_deleted(needle_id):
                self._ecj.write(needle_id.to_bytes(8, "big"))
                self._ecj.flush()

    # ---- data path ----

    @property
    def shard_size(self) -> int:
        for f in self.shards.values():
            return os.fstat(f.fileno()).st_size
        return 0

    @property
    def dat_size(self) -> int:
        return gf.DATA_SHARDS * self.shard_size

    # below this, a recover transform is dispatch-latency-bound and the
    # host AVX2/numpy path beats a device round trip (store_ec.go always
    # pays the CPU cost; we pay it only where it wins). The DEFAULT for
    # the measured, per-volume `small_recover_bytes` (-ec.smallrecover)
    SMALL_RECOVER_BYTES = 1 << 20

    def encoder(self, interval_size: int | None = None):
        if self._encoder is not None:  # explicit injection always wins
            return self._encoder
        if (interval_size is not None
                and interval_size < self.small_recover_bytes):
            if self._small_encoder is None:
                from .encoder_cpu import CpuEncoder
                self._small_encoder = CpuEncoder()
            return self._small_encoder
        if self._default_encoder is None:
            self._default_encoder = get_encoder()
        return self._default_encoder

    def _read_shard_interval(self, sid: int, offset: int, size: int) -> bytes:
        """local shard -> remote fetch -> on-the-fly reconstruct
        (readOneEcShardInterval, store_ec.go:178-209)."""
        return self._read_interval_src(sid, offset, size)[0]

    def _read_interval_src(self, sid: int, offset: int, size: int
                           ) -> "tuple[bytes, tuple, bool]":
        """_read_shard_interval, also saying where the bytes came from:
        (bytes, the shard rows they were read or decoded from, whether
        they were decoded). A recover served from the recover cache
        names no rows: those bytes passed a needle CRC before."""
        data = self._read_direct(sid, offset, size)
        if data is not None:
            return data, (sid,), False
        data, rows = self._recover_interval_src(sid, offset, size)
        return data, rows, True

    def _read_direct(self, sid: int, offset: int, size: int
                     ) -> "bytes | None":
        """One interval from its own shard: a pread of the local file,
        else fetch_remote; None where neither has it."""
        f = self.shards.get(sid)
        if f is not None:
            failpoints.sync_fail("ec.shard_read")
            # pread: position-independent, safe under concurrent readers
            with tracing.start("ec", "pread"):
                data = os.pread(f.fileno(), size, offset)
            if len(data) == size:
                return data
            return data + b"\x00" * (size - len(data))
        if self.fetch_remote is not None:
            return self.fetch_remote(sid, offset, size)
        return None

    # ---- repair planning (minimal-fetch degraded reads) ----

    def invalidate_plans(self) -> None:
        """Drop cached repair plans: shard mount/unmount (the missing
        set moved) or a holder-map refresh (the remote grouping
        moved). Cheap — plans rebuild lazily on the next recover."""
        self._plans.clear()

    def _repair_plan(self, want_sid: int) -> RepairPlan:
        """The cached survivor preference order for the current
        missing-set (every shard with no local file). One plan serves
        every lost shard and every offset: `want_sid` is excluded at
        selection time, and which remote rows actually move is decided
        per interval after cached bytes are consumed."""
        local = sorted(self.shards)
        missing = frozenset(range(gf.TOTAL_SHARDS)) - frozenset(local)
        plan = self._plans.get(missing)
        if plan is not None:
            return plan
        holders: dict = {}
        if self.holder_peek is not None:
            try:
                holders = self.holder_peek() or {}
            except Exception as e:  # noqa: BLE001 — planning is an
                # optimization; a failed peek degrades to sid order
                glog.V(2).infof("ec plan holder peek vid=%d: %s",
                                self.vid, e)
        groups: dict[object, list[int]] = {}
        for sid in sorted(missing):
            groups.setdefault(holders.get(sid), []).append(sid)
        plan = RepairPlan(local, order_holder_groups(groups))
        self._plans[missing] = plan
        return plan

    def _recover_interval(self, want_sid: int, offset: int, size: int) -> bytes:
        return self._recover_interval_src(want_sid, offset, size)[0]

    def _recover_interval_src(self, want_sid: int, offset: int, size: int
                              ) -> "tuple[bytes, tuple]":
        """One lost interval: from the reconstruction cache where it is
        hot, else decoded by _recover_rows_src.

        read_needle reaches each of its lost intervals through here, one
        at a time (the per-interval seam that fault injection replaces),
        with the read's row groups set on this thread (self._rows): the
        first interval asked for of a (offset, size) takes the read's
        other uncached lost intervals there into the same recover, and
        their outputs wait on the thread until they are asked for.
        Elsewhere it is a recover of one row.

        Returns the bytes and the survivor rows decoded ((), when the
        recover cache served them)."""
        rc = self._recover_cache
        ctx = self._rows
        groups = getattr(ctx, "groups", None)
        key = (self.vid, want_sid, offset, size)
        if groups is not None and key in ctx.done:
            return ctx.done.pop(key)
        others = [sid for sid in (groups or {}).pop((offset, size), ())
                  if sid != want_sid]
        if rc is not None:
            cached = rc.get(key)
            if cached is not None:
                if others:      # the group waits for its next interval
                    groups[(offset, size)] = others
                return cached, ()
        want = [want_sid]
        for sid in others:
            other = (self.vid, sid, offset, size)
            cached = rc.get(other) if rc is not None else None
            if cached is not None:
                ctx.done[other] = (cached, ())
            else:
                want.append(sid)
        outs, rows = self._recover_rows_src(tuple(want), offset, size)
        for sid, data in zip(want[1:], outs[1:]):
            ctx.done[(self.vid, sid, offset, size)] = (data, rows)
        return outs[0], rows

    def _recover_rows_src(self, want_sids: tuple, offset: int, size: int
                          ) -> "tuple[list[bytes], tuple]":
        """Gather k survivor rows of one interval and decode every lost
        shard in `want_sids` at that same (offset, size) from them in
        one transform (recoverOneRemoteEcShardInterval,
        store_ec.go:319-373, for r rows at once) — minimal-fetch: the
        repair plan orders survivors local-first, then cached, then
        remote grouped by holder, and exactly the k rows the decode
        needs are read (arxiv 2306.10528). No wanted shard is a
        survivor. The host-or-card choice follows the interval's size,
        not the r x size bytes decoded.

        Each decoded interval goes into the reconstruction cache under
        its own key; remotely fetched SURVIVOR rows are cached under the
        same keyspace, so recovering another lost shard of the same
        stripe later re-uses the bytes already moved instead of
        re-fetching them.

        Returns one output per wanted shard, in `want_sids` order, and
        the survivor rows decoded."""
        rc = self._recover_cache
        wanted = set(want_sids)
        gen = None
        # generation snapshot BEFORE gathering (EcRecoverCache; a plain
        # LruByteCache in tests has no generations): a re-encode/remount
        # racing this reconstruction bumps it and the stale fills below
        # are refused
        if rc is not None and hasattr(rc, "generation"):
            gen = rc.generation(self.vid)
        # traced as its own span: the GF(256) gather+decode is the
        # dominant degraded-read cost (arxiv 2306.10528) and must be
        # attributable per request, not only in aggregate
        with tracing.start("ec", "recover", vid=self.vid,
                           want=list(want_sids),
                           rows=len(want_sids)) as sp:
            failpoints.sync_fail("ec.recover.read")
            plan = self._repair_plan(want_sids[0])
            k = gf.DATA_SHARDS
            # the survivors' reads: local, cached, fetched
            with tracing.start("ec", "gather") as gsp:
                got: dict[int, bytes] = {}
                stale_local: list[int] = []
                for sid in plan.local:
                    if len(got) >= k:
                        break
                    if sid in wanted:
                        continue
                    f = self.shards.get(sid)
                    if f is None:
                        # unmounted between planning and this read: the
                        # shard may now live on a peer — demote it to a
                        # remote candidate instead of dropping the row
                        stale_local.append(sid)
                        continue
                    raw = os.pread(f.fileno(), size, offset)
                    got[sid] = raw + b"\x00" * (size - len(raw))
                n_local = len(got)
                # cached survivor intervals: bytes a previous recover of
                # ANOTHER lost shard already moved — free the second time
                if rc is not None and len(got) < k:
                    for sid in plan.remote:
                        if len(got) >= k:
                            break
                        if sid in wanted:
                            continue
                        b = rc.get((self.vid, sid, offset, size))
                        if b is not None and len(b) == size:
                            got[sid] = b
                n_cached = len(got) - n_local
                fetched: dict[int, bytes] = {}
                want_remote = [sid for sid in plan.remote
                               if sid not in wanted and sid not in got] \
                    + stale_local
                refreshed = False

                def gather(cands: list[int], need: int) -> None:
                    if need <= 0 or not cands or \
                            self.fetch_remote_batch is None:
                        return
                    # only as many intervals as the decode still needs:
                    # over-asking would move (and pread) extra repair
                    # bytes on every holder
                    batch = self.fetch_remote_batch(
                        [(sid, offset, size) for sid in cands[:need]])
                    if not batch:
                        return
                    taken = 0
                    # `need` bounds THIS call's acceptance: the retry
                    # gather after a partially-successful first batch must
                    # still be able to admit its rows (the shared dict
                    # already holds the first batch's)
                    for sid in cands:
                        data = batch.get(sid)
                        if data is not None and taken < need:
                            fetched[sid] = data
                            taken += 1

                gather(want_remote, k - len(got))
                if len(got) + len(fetched) < k and want_remote:
                    # the batch came back short: refresh the holder map
                    # ONCE, then retry the remainder as a SECOND batch —
                    # never a per-shard loop against the same stale
                    # holders for every shard in the batch. (The wired
                    # batch fetcher may itself have invalidated the map
                    # already — either way the next resolve sees the
                    # freshest state, so the retry is issued
                    # unconditionally: one batched attempt costs at most
                    # one wasted round trip, strictly cheaper than the
                    # k-shortfall per-shard singles it preempts.)
                    if self.refresh_holders is not None:
                        try:
                            self.refresh_holders()
                        except Exception as e:  # noqa: BLE001 — refresh is
                            # best-effort; the per-shard fallback still runs
                            glog.V(1).infof("ec holder refresh vid=%d: %s",
                                            self.vid, e)
                        refreshed = True
                        self.invalidate_plans()
                    gather([sid for sid in want_remote
                            if sid not in fetched],
                           k - len(got) - len(fetched))
                    # last resort: per-shard fetch for stragglers, against
                    # the refreshed map
                    if len(got) + len(fetched) < k \
                            and self.fetch_remote is not None:
                        for sid in want_remote:
                            if sid in fetched:
                                continue
                            if len(got) + len(fetched) >= k:
                                break
                            data = self.fetch_remote(sid, offset, size)
                            if data is not None:
                                fetched[sid] = data
                got.update(fetched)
                gsp.set("local", n_local)
                gsp.set("cached", n_cached)
                gsp.set("fetched", len(fetched))
            bufs: list[np.ndarray] = []
            rows: list[int] = []
            for sid in sorted(got):
                if len(rows) == k:
                    break
                rows.append(sid)
                bufs.append(np.frombuffer(got[sid], np.uint8))
            sp.set("shards", list(rows))
            if refreshed:
                sp.event("holder_refresh")
            if len(rows) < k:
                raise EcVolumeError(
                    f"cannot recover shards {list(want_sids)}: only "
                    f"{len(rows)} sources available")
            glog.V(3).infof(
                "ec recover vid=%d shards=%s off=%d size=%d from %s "
                "(local=%d cached=%d fetched=%d)",
                self.vid, list(want_sids), offset, size, rows,
                n_local, n_cached, len(fetched))
            coeff = gf.cached_shard_rows(tuple(want_sids), tuple(rows))
            encoder = self.encoder(size)
            path = "card" if on_card(encoder) else "host"
            sp.set("path", path)
            run = _transform_buffers_async(encoder, coeff, bufs)
            sp.set("pieces", run.pieces)
            datas = [np.asarray(o, np.uint8).tobytes() for o in run()]
            sp.nbytes = len(want_sids) * size
            _count_recover(path, len(want_sids), run.pieces)
            if rc is not None:
                keys = [(self.vid, sid, offset, size) for sid in want_sids]
                if gen is not None:
                    for key, data in zip(keys, datas):
                        rc.put_fenced(key, data, gen)
                    # survivor rows that moved over the network are
                    # worth keeping too: a follow-up recover of a
                    # DIFFERENT lost shard of this stripe reuses them
                    # (same fence — stale survivor bytes must lose to
                    # a re-encode exactly like decoded ones)
                    for sid, b in fetched.items():
                        rc.put_fenced((self.vid, sid, offset, size),
                                      b, gen)
                else:
                    for key, data in zip(keys, datas):
                        rc.put(key, data)
                    for sid, b in fetched.items():
                        rc.put((self.vid, sid, offset, size), b)
            return datas, tuple(rows)

    def read_window_block(self, offset: int, count: int, size: int,
                          strict: bool = False,
                          stats: dict | None = None) -> np.ndarray:
        """Gather `count` consecutive stripe windows of `size` bytes
        into one (count, 14, size) uint8 block — the scrub unit of the
        stripe-batch engine. ONE pread (or one remote fetch) per shard
        covers the whole block; rows past shard EOF read as zeros, and
        since the stored parity there is zeros too, padded tail windows
        verify clean by construction.

        strict=True (the scrubber) refuses to substitute a
        RECONSTRUCTED row when a holder stops serving mid-cycle:
        parity recomputed from rows derived from the other rows
        matches trivially, so a 'clean' verdict would claim evidence
        about bytes that were never examined — the unreachable shard
        raises EcVolumeError instead and the volume's pass is reported
        as an error, not a clean scan. strict=False keeps the
        verify_parity semantics (recovered rows allowed, flagged
        volume-wide via used_recovered_rows).

        The `scrub.read` failpoint (action `flip`) corrupts rows here,
        applied per WINDOW row exactly like the pre-batching path (one
        potential fire per window per shard) — the injection point the
        scrub soak uses to prove planted corruption is detected while
        foreground reads stay clean."""
        nbytes = count * size
        rows = []
        local_preads = 0
        remote_rows = 0
        for sid in range(gf.TOTAL_SHARDS):
            if sid in self.shards:
                local_preads += 1
            else:
                remote_rows += 1
            if strict and sid not in self.shards:
                data = (self.fetch_remote(sid, offset, nbytes)
                        if self.fetch_remote is not None else None)
                if data is None:
                    raise EcVolumeError(
                        f"shard {sid} unreachable mid-scrub: window "
                        f"{offset} has no evidence for it")
            else:
                data = self._read_shard_interval(sid, offset, nbytes)
            if len(data) < nbytes:
                data = data + b"\x00" * (nbytes - len(data))
            rows.append(np.frombuffer(data, np.uint8).reshape(count, size))
        from .batch import add_stat
        # preads = LOCAL shard reads only; rows served by a peer (or
        # reconstructed) are accounted as remote_rows — a degraded
        # volume's verify report must not claim disk reads it never did
        add_stat(stats, preads=local_preads, remote_rows=remote_rows,
                 bytes_read=nbytes * gf.TOTAL_SHARDS)
        block = np.stack(rows, axis=1)
        if failpoints.armed():
            # window-major, sid-ascending — the exact fire order of the
            # pre-batching per-window path, so `flip:N` grammars plant
            # corruption in the same windows batched or not
            for w in range(count):
                for sid in range(gf.TOTAL_SHARDS):
                    d = failpoints.corrupt("scrub.read",
                                           block[w, sid].tobytes())
                    if len(d) != size:  # truncate armed: keep row shape
                        d = d[:size] + b"\x00" * (size - len(d))
                    block[w, sid] = np.frombuffer(d, np.uint8)
        return block

    def verify_window_block(self, offset: int, count: int, size: int,
                            strict: bool = False,
                            stats: dict | None = None) -> list[bool]:
        """Recompute RS(10,4) parity over `count` consecutive stripe
        windows in ONE batched transform dispatch and compare against
        the stored parity rows -> per-window verdicts. Every backend
        answers through the same `verify_batch(block)` surface — no
        per-encoder branching."""
        from .batch import verify_block
        block = self.read_window_block(offset, count, size, strict, stats)
        return verify_block(self.encoder(count * size), block, stats)

    def verify_window(self, offset: int, size: int,
                      strict: bool = False) -> bool:
        """One-window verify — the count=1 case of
        verify_window_block (the scrub unit before stripe batching;
        kept as the /admin and test-facing primitive)."""
        return self.verify_window_block(offset, 1, size, strict)[0]

    def missing_shards(self) -> list[int]:
        """Shards neither local nor remotely fetchable (they verify via
        rebuild, not scrub)."""
        return [sid for sid in range(gf.TOTAL_SHARDS)
                if sid not in self.shards
                and (self.fetch_remote is None
                     or self.fetch_remote(sid, 0, 1) is None)]

    def verify_parity(self, window_size: int = 4 << 20,
                      batch_windows: int | None = None) -> dict:
        """Scrub: recompute RS(10,4) parity over every stripe window and
        compare against the stored parity shards — a whole-volume
        bit-rot check that runs as the same GF(256) device transform the
        encoder uses (the reference has no equivalent; its integrity
        stops at per-needle CRCs on read, needle/crc.go).

        Runs through the stripe-batch engine: `batch_windows` windows
        per transform dispatch (ceil(W/B) dispatches per volume; the
        tail block zero-pads past shard EOF, which verifies clean by
        construction). Missing local shards are listed (they verify
        via rebuild, not here); windows containing RECOVERED rows
        can't add evidence and are flagged. Returns {"windows",
        "bad_windows": [offsets], "missing_shards": [sids],
        "shard_size", "batches", "dispatches", "preads"}."""
        from .batch import (DEFAULT_BATCH_WINDOWS, clamp_batch_windows,
                            window_blocks)
        if batch_windows is None:
            batch_windows = DEFAULT_BATCH_WINDOWS
        batch_windows = clamp_batch_windows(batch_windows, window_size,
                                            gf.TOTAL_SHARDS)
        ssize = self.shard_size
        missing = self.missing_shards()
        bad: list[int] = []
        n_windows = -(-ssize // window_size) if ssize else 0
        stats: dict = {}
        for wi, count in window_blocks(n_windows, batch_windows):
            off = wi * window_size
            for i, ok in enumerate(
                    self.verify_window_block(off, count, window_size,
                                             stats=stats)):
                if not ok:
                    bad.append(off + i * window_size)
        return {"windows": n_windows, "bad_windows": bad,
                "missing_shards": missing, "shard_size": ssize,
                "batches": stats.get("batches", 0),
                "dispatches": stats.get("dispatches", 0),
                "preads": stats.get("preads", 0),
                "remote_rows": stats.get("remote_rows", 0),
                "used_recovered_rows": len(missing) > 0}

    @contextmanager
    def _locked(self):
        """Hold the volume's lock; under a traced request the wait for it
        is an `ec.lock_wait` span."""
        with tracing.start("ec", "lock_wait"):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    def read_needle(self, needle_id: int, cookie: int | None = None) -> Needle:
        """Locate via .ecx, gather stripe intervals, parse + CRC-check
        (ReadEcShardNeedle, store_ec.go:119-153). A CRC mismatch is
        answered by _reread_without_culprit, which serves the needle
        only where exactly one survivor left out makes it pass."""
        with self._locked():
            offset, size = self.find_needle(needle_id)
            if size == t.TOMBSTONE_FILE_SIZE:
                raise NotFoundError(f"needle {needle_id:x} deleted")
            record_len = t.actual_size(size, self.version)
            intervals = locate_data(self.large_block, self.small_block,
                                    self.dat_size, offset, record_len)
            # first pass, in interval order: an intact shard's pread or a
            # peer's bytes, else pending, grouped by (shard offset, size):
            # lost intervals of one stripe row share their survivors
            parts, reads = [], []
            groups: dict[tuple, list[int]] = {}
            for iv in intervals:
                sid, soff = iv.to_shard_and_offset(self.large_block,
                                                   self.small_block)
                data = self._read_direct(sid, soff, iv.size)
                if data is None:
                    groups.setdefault((soff, iv.size), []).append(sid)
                parts.append(data)
                reads.append((sid, soff, iv.size, (sid,), False))
            # second pass, in interval order: the first lost interval of
            # each group recovers the group's uncached ones at once
            self._rows.groups, self._rows.done = groups, {}
            try:
                for i, (sid, soff, n, _, _) in enumerate(reads):
                    if parts[i] is None:
                        parts[i], rows = self._recover_interval_src(
                            sid, soff, n)
                        reads[i] = (sid, soff, n, rows, True)
            finally:
                self._rows.groups = self._rows.done = None
        try:
            n = Needle.from_bytes(b"".join(parts), self.version)
        except CrcMismatch as e:
            n = self._reread_without_culprit(needle_id, reads, parts, e)
        if cookie is not None and n.cookie != cookie:
            raise NotFoundError(f"cookie mismatch for {needle_id:x}")
        return n

    def _gather_rows(self, want_sid: int, offset: int, size: int
                     ) -> "dict[int, bytes]":
        """Every other shard's row of one interval that can be had: the
        local ones by pread, the rest through fetch_remote_batch (one
        request per holder) and then fetch_remote for what the batch
        did not bring. Never the recover cache."""
        got: dict[int, bytes] = {}
        for sid, f in sorted(self.shards.items()):
            if sid != want_sid:
                raw = os.pread(f.fileno(), size, offset)
                got[sid] = raw + b"\x00" * (size - len(raw))
        cands = [sid for sid in range(gf.TOTAL_SHARDS)
                 if sid != want_sid and sid not in got]
        if cands and self.fetch_remote_batch is not None:
            batch = self.fetch_remote_batch(
                [(sid, offset, size) for sid in cands]) or {}
            for sid in cands:
                if batch.get(sid) is not None:
                    got[sid] = batch[sid]
        if self.fetch_remote is not None:
            for sid in cands:
                if sid not in got:
                    data = self.fetch_remote(sid, offset, size)
                    if data is not None:
                        got[sid] = data
        return {sid: b for sid, b in got.items() if len(b) == size}

    def _reread_without_culprit(self, needle_id: int, reads: list,
                                parts: "list[bytes]",
                                err: CrcMismatch) -> Needle:
        """A needle failed its CRC: find the one rotten survivor.

        The failed decodes and the survivor rows fetched for them leave
        the recover cache first. Then, for each shard c that the read
        took bytes from (a row read directly, or a source of a decode),
        every interval that used c is read again without it: a direct
        row is decoded from k others, a decode takes its other k - 1
        sources and one survivor it did not use. That needs k + 1
        survivors of the interval, local or fetched. Where exactly one
        c makes the needle parse and pass its CRC, those bytes are
        served, their decodes are cached, and c is reported as rot in
        the scrubber's structured form, at the shard offsets where the
        first read's bytes differ from them. Otherwise the read fails with
        `err`: no bytes that failed the check are served, and no shard
        that could not be pinned is reported.

        Each retried interval is one more transform of (1, k, size),
        on the card at or above small_recover_bytes. The intact path
        and the first decode do none of this."""
        import time

        from ..util import events
        k = gf.DATA_SHARDS
        rc = self._recover_cache
        with self._locked(), tracing.start("ec", "reread", vid=self.vid,
                                           needle=needle_id) as sp:
            self.rereads += 1
            gen = (rc.generation(self.vid)
                   if rc is not None and hasattr(rc, "generation") else None)
            if rc is not None:
                for _sid, off, size, _rows, decoded in reads:
                    if decoded:
                        for sid in range(gf.TOTAL_SHARDS):
                            rc.delete((self.vid, sid, off, size))
            rows_of: dict[int, dict[int, bytes]] = {}
            suspects = sorted({s for r in reads for s in r[3]})
            passed = []
            for c in suspects:
                blob = list(parts)
                for i, (sid, off, size, rows, decoded) in enumerate(reads):
                    if c not in rows:
                        continue
                    if i not in rows_of:
                        rows_of[i] = self._gather_rows(sid, off, size)
                    have = rows_of[i]
                    keep = [s for s in rows if s != c and s in have] \
                        if decoded else []
                    srcs = (keep + [s for s in sorted(have)
                                    if s != c and s not in rows])[:k]
                    if len(srcs) < k:
                        break
                    coeff = gf.cached_shard_rows((sid,), tuple(sorted(srcs)))
                    out = _transform_buffers(
                        self.encoder(size), coeff,
                        [np.frombuffer(have[s], np.uint8)
                         for s in sorted(srcs)])
                    blob[i] = np.asarray(out[0], np.uint8).tobytes()
                else:
                    try:
                        n = Needle.from_bytes(b"".join(blob), self.version)
                    except (NeedleError, IndexError, ValueError):
                        continue
                    if n.id == needle_id:
                        passed.append((c, n, blob))
            sp.set("suspects", suspects)
            sp.set("passed", [c for c, _, _ in passed])
            if len(passed) != 1:
                glog.warning("ec reread vid=%d needle=%x: %d of %d "
                             "survivors left out pass the CRC; failing "
                             "the read", self.vid, needle_id, len(passed),
                             len(suspects))
                raise err
            c, n, blob = passed[0]
            if rc is not None:
                for i, (sid, off, size, _rows, decoded) in enumerate(reads):
                    if decoded:
                        if gen is not None:
                            rc.put_fenced((self.vid, sid, off, size),
                                          blob[i], gen)
                        else:
                            rc.put((self.vid, sid, off, size), blob[i])
            # where the rot lies: the bytes the first read got wrong
            diff = [reads[i][1] + int(j) for i in range(len(reads))
                    if blob[i] is not parts[i]
                    for j in np.flatnonzero(
                        np.frombuffer(blob[i], np.uint8)
                        != np.frombuffer(parts[i], np.uint8))]
            if not diff:    # the first read's bytes came from elsewhere
                diff = [off + d for _sid, off, size, rows, _ in reads
                        if c in rows for d in (0, size - 1)]
            lo, hi = min(diff), max(diff) + 1
            report = {"volume": self.vid, "window": lo // REPORT_WINDOW,
                      "offset": lo, "size": hi - lo, "shards": [c],
                      "wall": time.time(), "found_by": "read"}
            glog.error("ec read vid=%d needle=%x: shard %d is rotten at "
                       "offset %d size %d; served the needle without it",
                       self.vid, needle_id, c, lo, hi - lo)
            events.record("ec_rot_found", vid=self.vid, shards=[c],
                          offset=lo, size=hi - lo, found_by="read")
            if self.report_rot is not None:
                self.report_rot(report)
            return n

    def close(self) -> None:
        self._ecx.close()
        self._ecj.close()
        for f in self.shards.values():
            f.close()

    def destroy(self) -> None:
        self.close()
        for ext in [".ecx", ".ecj"] + [to_ext(i) for i in range(gf.TOTAL_SHARDS)]:
            p = self.base_name + ext
            if os.path.exists(p):
                os.remove(p)
