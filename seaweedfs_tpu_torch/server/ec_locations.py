"""EC shard-location cache with staleness tiers.

Reference: weed/storage/store_ec.go:218-259 (cachedLookupEcShardLocations)
— the volume server caches vid -> shard locations so a burst of degraded
reads costs ONE master lookup, not one per interval fetch. Three windows:

  FRESH_S  (11s): after any lookup attempt (success or failure), no new
           lookup is issued for the same vid — a reconstruction storm
           cannot hammer the master.
  TTL_S    (7m): a successful result is served without re-lookup.
  EXPIRE_S (37m): on lookup failure, the last known locations keep being
           served (stale-while-error) until this age, then drop.

A copy of seaweedfs_tpu/server/ec_locations.py in the PyTorch port.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class _Entry:
    # time.monotonic() can legitimately be near 0.0 right after boot, so
    # every "never happened" sentinel is -inf-ish, not 0.0
    locations: dict | None = None   # {"shard_id_str": [urls]}
    fetched_at: float = -1e9        # last SUCCESSFUL lookup
    attempted_at: float = -1e9      # last lookup attempt of any outcome
    last_forced: float = -1e9       # last invalidate() that forced a lookup
    stale: bool = False             # invalidated: re-lookup when allowed
    lock: threading.Lock = field(default_factory=threading.Lock)


class EcLocationCache:
    FRESH_S = 11.0
    TTL_S = 7 * 60.0
    EXPIRE_S = 37 * 60.0

    def __init__(self, lookup: Callable[[int], dict | None],
                 now: Callable[[], float] = time.monotonic):
        self._lookup = lookup
        self._now = now
        self._entries: dict[int, _Entry] = {}
        self._lock = threading.Lock()

    def _entry(self, vid: int) -> _Entry:
        with self._lock:
            return self._entries.setdefault(vid, _Entry())

    def get(self, vid: int) -> dict | None:
        """Locations for vid, freshly looked up only when the cache says
        so. Called from executor threads; per-vid lock keeps a storm down
        to one in-flight lookup."""
        e = self._entry(vid)
        now = self._now()
        with e.lock:
            if (e.locations is not None and not e.stale
                    and now - e.fetched_at < self.TTL_S):
                return e.locations
            if now - e.attempted_at < self.FRESH_S:
                # a lookup just happened (maybe by another reader):
                # serve whatever we have rather than dialing again
                return self._stale_or_none(e, now)
            e.attempted_at = now
            locs = None
            try:
                locs = self._lookup(vid)
            except Exception:  # noqa: BLE001 — treated as lookup failure
                locs = None
            if locs is not None:
                e.locations = locs
                e.fetched_at = now
                e.stale = False
                return locs
            return self._stale_or_none(e, now)

    def _stale_or_none(self, e: _Entry, now: float) -> dict | None:
        if e.locations is not None and now - e.fetched_at < self.EXPIRE_S:
            return e.locations
        e.locations = None
        return None

    def peek(self, vid: int) -> dict | None:
        """Whatever locations are cached RIGHT NOW, with no lookup and
        no staleness bookkeeping — the repair planner's holder-grouping
        input (a plan built from slightly stale holders still fetches
        correct bytes; the fetchers re-resolve on failure)."""
        e = self._entries.get(vid)
        return e.locations if e is not None else None

    def invalidate(self, vid: int) -> bool:
        """A shard fetch against cached locations failed: the topology
        has moved under us. The FIRST invalidation in a FRESH_S window
        forces an immediate re-lookup (a degraded read right after a
        shard move must not stay stuck on dead holders); further
        invalidations inside the window fall back to the normal
        suppression, so an every-holder-down storm still costs at most
        one master lookup per FRESH_S. Returns whether this call
        forced the immediate re-lookup (informational)."""
        e = self._entry(vid)
        now = self._now()
        with e.lock:
            e.stale = True  # next allowed get() re-resolves; until then
            #                 the existing map keeps serving by real age
            if now - e.last_forced >= self.FRESH_S:
                e.attempted_at = -1e9
                e.last_forced = now
                # journal the forced refresh (rate-bounded to one per
                # FRESH_S per vid by construction): a degraded-read
                # burst chasing a moved holder map is core evidence for
                # a latency violation window
                from ..util import events
                events.record("holder_refresh", vid=vid)
                return True
            return False
