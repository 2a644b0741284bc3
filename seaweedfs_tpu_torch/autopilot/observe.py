"""Observe phase: build a frozen ClusterSnapshot from live evidence.

Four sources, all of which earlier PRs built as *reporting* surfaces
and the autopilot now consumes as *inputs*:

* the leader's in-process ``Topology`` (heartbeat-fed node/volume/EC
  registries — rack placement, free slots, per-volume deletion
  counters, liveness);
* every live holder's ``/debug/scrub`` — specifically the
  machine-readable per-cycle ``corrupt_windows`` rows (vid, window
  offset, localized shard ids) the scrubber emits since this PR,
  NOT the human-facing prose/corruption ring, and its
  ``found_windows``: the same rows for rot that a degraded read or a
  rebuild pinned to one survivor;
* every live holder's ``/debug/health`` verdict plus the master's own
  — any ``page`` anywhere parks the executor (repair traffic must
  never bury a foreground incident);
* the heartbeat ``remote`` bit on volume messages, so already-tiered
  volumes are never re-planned for tier_seal.

The observer is the only autopilot phase that touches the network; it
degrades gracefully (an unreachable holder contributes no scrub/health
evidence and is reported in ``errors``) and everything it returns is
immutable, so the planner downstream stays pure.

A copy of seaweedfs_tpu/autopilot/observe.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import time

import aiohttp

from ..security import tls
from ..storage.super_block import ReplicaPlacement
from ..util import failpoints, glog
from .plan import (ClusterSnapshot, CorruptionReport, EcVolumeState,
                   NodeState, VolumeState)

# concurrent per-node probes; a big fleet is walked in waves
_PROBE_FANOUT = 8


class Observer:
    """Builds snapshots for one MasterServer (leader-side only)."""

    def __init__(self, master, timeout_s: float = 10.0):
        self.master = master
        self.timeout_s = timeout_s

    # ---- HTTP probe helpers -------------------------------------------

    async def _get_json(self, url: str, path: str) -> dict:
        # chaos site: each observation probe is individually breakable
        # (a node whose evidence can't be read degrades, never wedges)
        await failpoints.fail("autopilot.observe")
        async with self.master._http.get(
                tls.url(url, path),
                timeout=aiohttp.ClientTimeout(
                    total=self.timeout_s)) as resp:
            if resp.status != 200:
                raise OSError(f"GET {url}{path}: http {resp.status}")
            return await resp.json()

    @staticmethod
    def _scrub_statuses(body: dict) -> "list[dict]":
        """Normalize a /debug/scrub GET body: a plain server answers
        {"scrub": {...}}, a -workers entry worker answers
        {"workers": {"0": {...}, ...}}."""
        if "scrub" in body:
            return [body["scrub"]]
        return [s for s in body.get("workers", {}).values()
                if isinstance(s, dict) and "state" in s]

    async def _probe_node(self, url: str,
                          corrupt: dict, errors: list) -> bool:
        """Scrub + health probe of one holder; returns its paging bit."""
        paging = False
        try:
            body = await self._get_json(url, "/debug/scrub")
            for st in self._scrub_statuses(body):
                last = st.get("last_cycle") or {}
                # a scrub cycle's localized windows, and the rot that
                # degraded reads and rebuilds pinned since
                for row in (list(last.get("corrupt_windows", ()))
                            + list(st.get("found_windows", ()))):
                    key = (int(row["volume"]), int(row["offset"]))
                    corrupt[key] = CorruptionReport(
                        vid=int(row["volume"]),
                        offset=int(row["offset"]),
                        size=int(row.get("size", 0)),
                        shards=tuple(sorted(
                            int(s) for s in row.get("shards", ()))))
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                ValueError, KeyError) as e:
            errors.append({"node": url, "surface": "scrub",
                           "error": str(e)[:160]})
        try:
            h = await self._get_json(url, "/debug/health")
            paging = h.get("status") == "page"
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                ValueError) as e:
            errors.append({"node": url, "surface": "health",
                           "error": str(e)[:160]})
        return paging

    async def any_paging(self) -> bool:
        """Fresh fleet-wide page check (the executor's pause gate):
        every live holder's /debug/health plus the master's own."""
        urls = [n.url for n in self._alive_nodes()] + [self.master.url]
        sem = asyncio.Semaphore(_PROBE_FANOUT)

        async def one(u: str) -> bool:
            async with sem:
                try:
                    h = await self._get_json(u, "/debug/health")
                    return h.get("status") == "page"
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError, ValueError):
                    return False    # unreachable != paging
        return any(await asyncio.gather(*(one(u) for u in urls)))

    # ---- topology distillation ----------------------------------------

    def _alive_nodes(self) -> list:
        topo = self.master.topo
        now = time.time()
        limit = 3 * topo.pulse_seconds
        return [n for n in topo.all_nodes()
                if now - n.last_seen <= limit]

    async def snapshot(self) -> "tuple[ClusterSnapshot, list[dict]]":
        """One full observation pass -> (snapshot, probe errors)."""
        # chaos site: a broken observer must surface as a failed cycle
        # (state visible in /debug/autopilot), never a wedged loop
        await failpoints.fail("autopilot.observe")
        alive = {n.url: n for n in self._alive_nodes()}
        nodes = tuple(sorted(
            (NodeState(url=n.url,
                       data_center=(n.rack.data_center.id
                                    if n.rack and n.rack.data_center
                                    else ""),
                       rack=n.rack.id if n.rack else "",
                       free_slots=n.free_space())
             for n in alive.values()),
            key=lambda s: s.url))

        topo = self.master.topo
        volumes = []
        for vid, locs in sorted(topo.volume_locations.items()):
            live = sorted(n.url for n in locs.values()
                          if n.url in alive)
            if not live:
                continue            # no live holder: nothing to act from
            msg = None
            for n in sorted(locs.values(), key=lambda n: n.url):
                if n.url in alive and vid in n.volumes:
                    msg = n.volumes[vid]
                    break
            if msg is None:
                continue
            try:
                copies = ReplicaPlacement.from_byte(
                    msg.replica_placement).copy_count
            except ValueError:
                copies = 1
            volumes.append(VolumeState(
                vid=vid, collection=msg.collection, size=msg.size,
                deleted_bytes=msg.deleted_byte_count,
                read_only=msg.read_only,
                remote=getattr(msg, "remote", False),
                replica_count=copies, holders=tuple(live)))

        ec_volumes = []
        for vid, by_shard in sorted(topo.ec_shard_locations.items()):
            shards = []
            for sid, holders in sorted(by_shard.items()):
                live = tuple(sorted(n.url for n in holders
                                    if n.url in alive))
                if live:
                    shards.append((sid, live))
            if shards:
                ec_volumes.append(EcVolumeState(
                    vid=vid,
                    collection=topo.collections.get(vid, ""),
                    shards=tuple(shards)))

        # scrub + health fan-out over every live holder (+ the leader
        # itself for health); unreachable nodes degrade to "no
        # evidence", recorded in errors
        corrupt: dict[tuple, CorruptionReport] = {}
        errors: list[dict] = []
        sem = asyncio.Semaphore(_PROBE_FANOUT)

        async def probe(u: str) -> bool:
            async with sem:
                return await self._probe_node(u, corrupt, errors)

        paging_bits = list(await asyncio.gather(
            *(probe(u) for u in sorted(alive))))
        try:
            h = await self._get_json(self.master.url, "/debug/health")
            paging_bits.append(h.get("status") == "page")
        except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                ValueError) as e:
            glog.V(2).infof("autopilot: master health probe: %s", e)

        snap = ClusterSnapshot(
            nodes=nodes,
            volumes=tuple(volumes),
            ec_volumes=tuple(ec_volumes),
            corruptions=tuple(corrupt[k] for k in sorted(corrupt)),
            volume_size_limit=self.master.volume_size_limit,
            paging=any(paging_bits))
        return snap, errors
