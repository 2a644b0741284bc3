"""Paced background EC parity scrubber.

The silent-corruption detector the reference lacks: its integrity
checking stops at per-needle CRCs *on read* (needle/crc.go), so a
flipped bit in a cold shard is discovered only when a degraded read
finally needs that row — mid-recovery, when redundancy is already
spent. This scrubber walks every mounted EC volume in stripe-batched
window blocks through ``EcVolume.read_window_block`` + the batch
engine's ``verify_block`` (the same GF(256) transform the encoder
uses, ONE dispatch per ``-scrub.batch`` windows, block N+1's preads
overlapping block N's verify) and reports corrupt windows BEFORE they
cost data.

Three disciplines keep it invisible to the foreground data plane:

* **token-bucket byte budget** (``-scrub.mbps``): every window's
  14 shard-row reads are paid for before they happen, so sustained
  scrub I/O can never exceed the operator's budget;
* **pause-on-foreground-latency** (``-scrub.pausems``): the unified
  wire layer feeds every served request's duration into
  ``foreground`` (the exact feed the
  ``SeaweedFS_volumeServer_request_seconds`` histogram observes);
  when recent foreground latency crosses the threshold the scrubber
  parks until the data plane has been healthy for a full window —
  a loaded or struggling server is never scrubbed harder;
* **executor isolation**: the reads + parity recompute run off the
  event loop, so a scrub window never stalls in-flight requests.

Observability: ``SeaweedFS_scrub_*`` metrics, a ``scrub`` trace span
per volume pass, and ``/debug/scrub`` status (+ ``POST ?run=1`` to
force a cycle — how the soak drives it deterministically). The
``scrub.read`` failpoint (action ``flip``) plants corruption the
scrubber must find; see tools/soak.py's ``scrub`` scenario.

A copy of seaweedfs_tpu/ec/scrub.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time

from ..util import events, glog, tracing
from . import gf
from .batch import (DEFAULT_BATCH_WINDOWS, clamp_batch_windows,
                    localize_corrupt_rows, verify_block)

# how long the scrubber sleeps while parked behind hot foreground
# traffic before re-checking
_PAUSE_SLEEP_S = 0.25


class ForegroundLoad:
    """Recent-request latency window fed by wire.observe(), answering
    one question: has any foreground request in the last `window_s`
    been slower than `pause_ms`?

    Aggregated into per-second (count, max-duration) buckets, NOT a
    per-request ring: a request-count-bounded ring evicts its evidence
    fastest exactly when the server is busiest — at 500 req/s a 512-
    entry ring covers ~1 s and a 2 s-old slow outlier is already gone.
    One bucket per wall second covers the window regardless of rate.
    note() runs only on the event-loop thread (wire.observe inside
    async handlers); the scrubber reads on the same loop."""

    __slots__ = ("_buckets",)

    # bucket deque length bounds the largest usable window_s
    MAX_WINDOW_S = 32

    def __init__(self):
        self._buckets: collections.deque = collections.deque(
            maxlen=self.MAX_WINDOW_S)   # [sec, count, max_dur_s]

    def clear(self) -> None:
        self._buckets.clear()

    def note(self, dur_s: float) -> None:
        sec = int(time.monotonic())
        b = self._buckets[-1] if self._buckets else None
        if b is not None and b[0] == sec:
            b[1] += 1
            if dur_s > b[2]:
                b[2] = dur_s
        else:
            self._buckets.append([sec, 1, dur_s])

    def snapshot(self, window_s: float) -> tuple[int, float]:
        """(request count, max duration ms) over the last window_s."""
        # whole-second buckets: include any bucket that overlaps the
        # window (err on the pause side, never evict evidence early)
        cutoff = int(time.monotonic() - window_s)
        count, worst = 0, 0.0
        for sec, n, mx in reversed(self._buckets):
            if sec < cutoff:
                break
            count += n
            if mx > worst:
                worst = mx
        return count, worst * 1000.0

    def hot(self, pause_ms: float, window_s: float) -> bool:
        if pause_ms <= 0:
            return False
        _, worst_ms = self.snapshot(min(window_s, self.MAX_WINDOW_S))
        return worst_ms >= pause_ms


# module-level singleton: server/wire.py notes every served request
# here (one deque append on the hot path), the scrubber consults it
foreground = ForegroundLoad()


class TokenBucket:
    """Byte-budget pacing: consume(n) debits n bytes, sleeping until
    the refill (rate bytes/s, burst-capped) covers them. rate <= 0
    disables pacing. Injectable clock/sleep for deterministic tests."""

    def __init__(self, rate_bytes_s: float, burst_bytes: float | None = None,
                 now=time.monotonic, sleep=asyncio.sleep):
        self.rate = rate_bytes_s
        self.burst = burst_bytes if burst_bytes is not None \
            else max(rate_bytes_s, 1.0)
        self._now = now
        self._sleep = sleep
        self._tokens = self.burst
        self._last = now()

    def _refill(self) -> None:
        now = self._now()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    async def consume(self, n: int) -> float:
        """Debit n bytes; returns seconds slept."""
        if self.rate <= 0:
            return 0.0
        self._refill()
        slept = 0.0
        # oversized requests (a window bigger than the burst) go
        # negative and simply earn back over time — a single huge
        # window must not deadlock the bucket
        if self._tokens < n:
            wait = (n - self._tokens) / self.rate
            await self._sleep(wait)
            slept = wait
            self._refill()
        self._tokens -= n
        return slept


class Scrubber:
    """Continuous paced parity scrub over a Store's mounted EC volumes.

    One instance per volume server (per -workers worker: each scrubs
    its own partition). `run()` is the long-lived background task —
    its handle is retained by the server and cancelled on stop (the
    weedlint orphan-task discipline for paced background loops);
    `run_cycle()` is one full pass, also callable via
    POST /debug/scrub?run=1."""

    # corruption reports kept for /debug/scrub (the full stream also
    # goes to glog.error and the corruptions counter)
    MAX_REPORTS = 64

    # the scrubber's own block budget, TIGHTER than ec/batch.py's
    # memory ceiling: for a paced background scan the bound is the
    # per-block I/O *burst* the foreground shares a disk with, so it
    # stays at the historical single-window footprint (~56 MB)
    BLOCK_BYTES = 64 << 20

    def __init__(self, store, mbps: float = 8.0,
                 interval_s: float = 300.0,
                 window_bytes: int = 1 << 20,
                 pause_ms: float = 50.0,
                 pause_window_s: float = 2.0,
                 load: ForegroundLoad | None = None,
                 batch_windows: int | None = None):
        self.store = store
        self.mbps = mbps
        self.interval_s = interval_s
        # 1 MB stripe windows (was 4 MB pre-batching): with windows
        # batched per dispatch the smaller unit costs nothing extra and
        # localizes rot 4x finer; the per-block I/O burst stays at the
        # historical ~56 MB because of the block byte budget below
        self.window_bytes = window_bytes
        self.pause_ms = pause_ms
        self.pause_window_s = pause_window_s
        # stripe-batch width (-scrub.batch): windows verified per GF
        # transform dispatch; the token bucket pays and the foreground
        # pause gate runs per BLOCK, so a bigger batch trades pacing
        # granularity for dispatch amortisation (1 = pre-batching
        # shape). Clamped so one (B, 14, window) block stays inside
        # BLOCK_BYTES — a 4 MB-window scrub can never burst a 448 MB
        # block of reads however the flag is set.
        if batch_windows is None:
            batch_windows = DEFAULT_BATCH_WINDOWS
        self.batch_windows = clamp_batch_windows(
            max(1, batch_windows), window_bytes, gf.TOTAL_SHARDS,
            budget=self.BLOCK_BYTES)
        self.bucket = TokenBucket(mbps * (1 << 20))
        self.load = load if load is not None else foreground
        self.state = "idle"
        self.current: dict | None = None
        self.cycles = 0
        self.windows = 0
        self.batches = 0         # window blocks == GF transform
        #                          dispatches (one per block; surfaced
        #                          under both names in /debug/scrub)
        self.corrupt_windows = 0
        self.bytes_scanned = 0
        self.pauses = 0          # pause EVENTS (not poll iterations)
        self.paused_s = 0.0      # total time parked behind foreground
        self.paced_sleep_s = 0.0
        # wall stamp for display, monotonic twin for the uptime DELTA
        # (an NTP step must not make uptime jump — the wall/monotonic
        # discipline every merged debug surface follows)
        self.started_at = time.time()
        self.started_mono = time.monotonic()
        self.corruptions: collections.deque = collections.deque(
            maxlen=self.MAX_REPORTS)
        # machine-readable corruption reports for the autopilot
        # observer: (vid, window index/offset/size, LOCALIZED shard
        # ids) — structure, not prose. The same rows ride each cycle
        # report as `corrupt_windows` so a consumer can distinguish
        # fresh evidence from the cumulative ring.
        self.reported: collections.deque = collections.deque(
            maxlen=self.MAX_REPORTS)
        self.last_cycle: dict | None = None
        self._cycle_lock = asyncio.Lock()
        # rot that a degraded read or a rebuild pinned to one survivor
        # (note_found_rot): (monotonic stamp, report) rows, served as
        # /debug/scrub `found_windows` for as long as a cycle's own
        # evidence stands (one -scrub.interval), so the autopilot
        # observes it like a localized scrub window
        self._found: collections.deque = collections.deque(
            maxlen=self.MAX_REPORTS)
        self._found_lock = threading.Lock()

    # ---- rot found outside the scrub ----

    # how long a found report stands when the scrub loop is off
    FOUND_TTL_S = 300.0

    def note_found_rot(self, report: dict) -> None:
        """Take a structured rot report from a read or a rebuild (any
        thread): it joins `reported` and rides `found_windows`."""
        with self._found_lock:
            self._found.append((time.monotonic(), dict(report)))
            self.reported.append(dict(report))

    def found_windows(self) -> "list[dict]":
        """The found reports younger than one scrub interval."""
        ttl = self.interval_s if self.interval_s > 0 else self.FOUND_TTL_S
        now = time.monotonic()
        with self._found_lock:
            return [r for t, r in self._found if now - t <= ttl]

    # ---- metrics ----

    def _count(self, name: str, n: float = 1, label: str | None = None
               ) -> None:
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        c = getattr(metrics, name)
        (c.labels(label) if label is not None else c).inc(n)

    # ---- the long-lived paced loop ----

    async def run(self) -> None:
        # first pass starts after ONE pacing interval, not at boot:
        # a restarting fleet must not synchronize a scrub stampede
        # with its own recovery traffic
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await self.run_cycle()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the scrubber must
                # outlive any single cycle's failure shape, visibly
                glog.warning("scrub cycle failed: %s: %s",
                             type(e).__name__, e)

    async def run_cycle(self) -> dict:
        """One full pass over every mounted EC volume. Serialized:
        a manual POST ?run=1 racing the background loop must not
        double-scan (and double-charge the budget)."""
        async with self._cycle_lock:
            t0 = time.monotonic()
            report = {"volumes": 0, "windows": 0, "batches": 0,
                      "dispatches": 0, "corrupt": 0,
                      "corrupt_windows": [],
                      "bytes": 0, "skipped": [], "errors": []}
            for vid in sorted(self.store.ec_volumes):
                ev = self.store.ec_volumes.get(vid)
                if ev is None:
                    continue  # unmounted while we scanned
                try:
                    await self._scrub_volume(vid, ev, report)
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 — one volume's
                    # failure (unmount race, dead holder) must not end
                    # the pass over the others
                    glog.warning("scrub vid=%d: %s: %s", vid,
                                 type(e).__name__, e)
                    report["errors"].append(
                        {"volume": vid, "error": str(e)})
            self.cycles += 1
            self._count("SCRUB_CYCLES")
            report["seconds"] = round(time.monotonic() - t0, 3)
            self.last_cycle = report
            self.state = "idle"
            self.current = None
            return report

    async def _scrub_volume(self, vid: int, ev, report: dict) -> None:
        if 0 not in ev.shards:
            # scrub ownership, decided FIRST because it is free (no
            # I/O): with shards spread across holders, every holder
            # scrubbing the full 14-row stripe would move the same
            # window bytes over the network once PER HOLDER per cycle
            # — and even the missing-shards probe below costs ~13
            # remote round trips per volume. Exactly one server scrubs
            # a volume: the holder of shard 0 (the lowest shard; a
            # volume whose shard 0 is LOST outright is skipped
            # everywhere — its stripe can't fully verify anyway).
            report["skipped"].append(
                {"volume": vid, "reason": "not-owner"})
            return
        ssize = await tracing.run_in_executor(lambda: ev.shard_size)
        missing = await tracing.run_in_executor(ev.missing_shards)
        if missing:
            # unreachable rows make the parity check inconclusive —
            # those shards verify via rebuild, not scrub
            report["skipped"].append(
                {"volume": vid, "missing_shards": missing})
            return
        report["volumes"] += 1
        n_windows = -(-ssize // self.window_bytes) if ssize else 0
        with tracing.start_root("scrub", "volume", vid=vid) as sp:
            # stripe-batched block loop with ONE-block read-ahead: the
            # preads of block N+1 (executor thread) overlap the GF
            # verify dispatch of block N (another executor thread) —
            # the scrub twin of the encode pipeline's double buffering.
            # Pacing discipline is preserved per BLOCK: every block's
            # bytes are paid for (token bucket) and the foreground
            # pause gate consulted BEFORE its reads are issued.
            wi = 0
            vol_bytes = 0
            self.current = None  # fresh volume: no stale position
            nxt = await self._pay_and_read(vid, ev, ssize, n_windows, 0) \
                if n_windows else None
            read_err: BaseException | None = None
            while nxt is not None and nxt != "unmounted":
                off, count, nbytes, block = nxt
                wi += count
                # `current` tracks the block being VERIFIED: the
                # read-ahead below must not advance the reported
                # position past windows whose verdicts aren't in yet
                # (a mid-cycle error would otherwise overstate
                # coverage by one block)
                self.current = {"volume": vid, "offset": off,
                                "shard_size": ssize, "windows": count}
                # encoder resolved INSIDE the executor thunk: first-use
                # lazy backend init (CUDA context, kernel build) must
                # never block the event loop mid-cycle
                verify_task = asyncio.ensure_future(
                    tracing.run_in_executor(
                        lambda b=block, n=count * self.window_bytes:
                        verify_block(ev.encoder(n), b)))
                nxt, read_err = None, None
                if wi < n_windows:
                    try:
                        # prefetch block N+1 while N verifies
                        nxt = await self._pay_and_read(
                            vid, ev, ssize, n_windows, wi)
                    except asyncio.CancelledError:
                        verify_task.cancel()
                        raise
                    except Exception as e:  # noqa: BLE001 — re-raised
                        # below, AFTER block N's verdicts are counted
                        read_err = e
                oks = await verify_task
                self.batches += 1
                report["batches"] += 1
                report["dispatches"] += 1
                self._count("SCRUB_BATCHES")
                self.windows += count
                self.bytes_scanned += nbytes
                vol_bytes += nbytes
                report["windows"] += count
                report["bytes"] += nbytes
                self._count("SCRUB_BYTES", nbytes)
                for i, ok in enumerate(oks):
                    woff = off + i * self.window_bytes
                    w = min(self.window_bytes, ssize - woff)
                    self._count("SCRUB_WINDOWS", 1,
                                "clean" if ok else "corrupt")
                    if ok:
                        continue
                    self.corrupt_windows += 1
                    report["corrupt"] += 1
                    self._count("SCRUB_CORRUPTIONS")
                    # localize the rot to one shard row (hypothesis
                    # test over the block row slice we already hold):
                    # the structured report the autopilot repairs
                    # from. [] = ambiguous — the consumer must defer.
                    try:
                        # encoder resolved INSIDE the thunk, like the
                        # verify dispatch: lazy backend init must not
                        # block the event loop mid-cycle
                        sids = await tracing.run_in_executor(
                            lambda r=block[i]: localize_corrupt_rows(
                                ev.encoder(self.window_bytes), r))
                    except Exception as e:  # noqa: BLE001 —
                        # localization is advisory evidence; its
                        # failure must not hide the corruption itself
                        glog.warning("scrub localize vid=%d off=%d: "
                                     "%s", vid, woff, e)
                        sids = []
                    rec = {"volume": vid, "offset": woff, "size": w,
                           "wall": time.time()}
                    self.corruptions.append(rec)
                    struct = {"volume": vid,
                              "window": woff // self.window_bytes,
                              "offset": woff, "size": w,
                              "shards": sids, "wall": rec["wall"]}
                    self.reported.append(struct)
                    report["corrupt_windows"].append(struct)
                    sp.event("corrupt_window", offset=woff, size=w,
                             shards=sids)
                    events.record("scrub_corruption", vid=vid,
                                  offset=woff, size=w, shards=sids)
                    glog.error(
                        "scrub: CORRUPT ec window vid=%d off=%d "
                        "size=%d shards=%s — stored parity disagrees "
                        "with recomputed RS(10,4)", vid, woff, w,
                        sids or "unlocalized")
                if read_err is not None:
                    raise read_err
            if nxt == "unmounted":
                sp.event("unmounted_midscrub")
                return  # unmounted/remounted under us: stop here
            # THIS volume's bytes, not the cycle-cumulative report sum
            sp.nbytes = vol_bytes

    async def _pay_and_read(self, vid: int, ev, ssize: int,
                            n_windows: int, wi: int):
        """Token-bucket pay + foreground-pause gate + read ONE window
        block starting at window index `wi`. Returns (offset, count,
        real_bytes, block), or "unmounted" when the volume moved under
        us (checked after the gates, before any read I/O)."""
        count = min(self.batch_windows, n_windows - wi)
        off = wi * self.window_bytes
        nbytes = (min(ssize - off, count * self.window_bytes)
                  * gf.TOTAL_SHARDS)
        self.state = "scrubbing"
        if self.current is None:  # first block of a volume: nothing is
            # verifying yet, so progress points at what is being read
            self.current = {"volume": vid, "offset": off,
                            "shard_size": ssize, "windows": count}
        # pay for the block BEFORE reading it
        self.paced_sleep_s += await self.bucket.consume(nbytes)
        if self.load.hot(self.pause_ms, self.pause_window_s):
            # one pause EVENT (however long the park lasts);
            # paused_s carries the duration
            self.state = "paused"
            self.pauses += 1
            self._count("SCRUB_PAUSES")
            while self.load.hot(self.pause_ms, self.pause_window_s):
                self.paused_s += _PAUSE_SLEEP_S
                await asyncio.sleep(_PAUSE_SLEEP_S)
            self.state = "scrubbing"
        if self.store.ec_volumes.get(vid) is not ev:
            return "unmounted"
        # strict: a row that would need RECONSTRUCTION mid-cycle
        # (holder died since the cycle's missing-shards probe) raises
        # instead of trivially verifying itself — the volume lands in
        # the cycle's errors, never in its clean windows
        block = await tracing.run_in_executor(
            ev.read_window_block, off, count, self.window_bytes, True)
        return off, count, nbytes, block

    # ---- /debug/scrub ----

    def status(self) -> dict:
        return {
            "enabled": self.interval_s > 0,
            "state": self.state,
            "current": self.current,
            "budget_mbps": self.mbps,
            "interval_s": self.interval_s,
            "window_bytes": self.window_bytes,
            "pause_ms": self.pause_ms,
            "batch_windows": self.batch_windows,
            "cycles": self.cycles,
            "windows": self.windows,
            "batches": self.batches,
            "dispatches": self.batches,  # one GF dispatch per block
            "corrupt_windows": self.corrupt_windows,
            "bytes_scanned": self.bytes_scanned,
            "pauses": self.pauses,
            "paused_s": round(self.paused_s, 3),
            "paced_sleep_s": round(self.paced_sleep_s, 3),
            "started_wall": round(self.started_at, 3),
            "uptime_s": round(time.monotonic() - self.started_mono, 1),
            "corruptions": list(self.corruptions),
            "reported_windows": list(self.reported),
            "found_windows": self.found_windows(),
            "last_cycle": self.last_cycle,
        }
