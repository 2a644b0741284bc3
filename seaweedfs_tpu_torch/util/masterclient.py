"""wdclient: long-lived master subscriber maintaining a vid→locations map.

Reference: weed/wdclient/masterclient.go:15-119 (`KeepConnectedToMaster`
/ `tryConnectToMaster` consuming the KeepConnected stream, with leader-
redirect failover) and weed/wdclient/vid_map.go:23-116 (round-robin
location lookup). The wire here is the master's /cluster/watch NDJSON
stream: one initial full snapshot, then {url, public_url, new_vids,
deleted_vids} deltas as heartbeats mutate the topology.

Used by filer / shell / gateways so hot-path fid lookups never hit the
master — they read a locally-maintained map that self-heals on volume
moves and node deaths.

A copy of seaweedfs_tpu/util/masterclient.py in the PyTorch port.
"""

from __future__ import annotations

from ..security import tls
from . import failpoints, glog
from .resilience import Backoff

import asyncio
import json
from dataclasses import dataclass

import aiohttp


class _LeaderRedirect(Exception):
    """Internal: the stream announced a different leader to follow."""


@dataclass(frozen=True)
class Location:
    url: str
    public_url: str


class MasterClient:
    def __init__(self, masters: list[str] | str, name: str = "client",
                 session: aiohttp.ClientSession | None = None):
        if isinstance(masters, str):
            masters = [masters]
        self.masters = masters
        self.current_master = masters[0]
        self.name = name
        self._session = session
        self._own = session is None
        self._vid_map: dict[int, list[Location]] = {}
        self._rr: dict[int, int] = {}
        self._task: asyncio.Task | None = None
        self._synced = asyncio.Event()
        self._stream_synced = False

    async def start(self) -> None:
        if self._session is None:
            # sock_read must outlast the master's 1s keepalive but fire on
            # a silently-dead peer, or failover never triggers
            self._session = tls.make_session(
                timeout=aiohttp.ClientTimeout(total=None, connect=10,
                                              sock_read=5.0))
        self._task = asyncio.create_task(self._keep_connected())

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        if self._own and self._session:
            await self._session.close()

    async def wait_synced(self, timeout: float = 10.0) -> None:
        """Block until the initial snapshot of at least one connect has
        been consumed."""
        await asyncio.wait_for(self._synced.wait(), timeout)

    # ---- lookup (vid_map.go) ----

    def lookup(self, vid: int) -> list[Location]:
        return list(self._vid_map.get(vid, []))

    def lookup_file_id(self, fid: str) -> str | None:
        """fid -> one public read URL, round-robin over replicas
        (vid_map.go:23-116)."""
        try:
            vid = int(fid.split(",")[0])
        except ValueError:
            return None
        locs = self._vid_map.get(vid)
        if not locs:
            return None
        i = self._rr.get(vid, 0) % len(locs)
        self._rr[vid] = i + 1
        return tls.url(locs[i].public_url, f"/{fid}")

    @property
    def vid_count(self) -> int:
        return len(self._vid_map)

    # ---- stream consumption (masterclient.go:45-119) ----

    def _apply(self, update: dict) -> None:
        loc = Location(url=update["url"],
                       public_url=update.get("public_url", update["url"]))
        for vid in update.get("new_vids", []):
            locs = self._vid_map.setdefault(int(vid), [])
            if loc not in locs:
                locs.append(loc)
        for vid in update.get("deleted_vids", []):
            locs = self._vid_map.get(int(vid))
            if not locs:
                continue
            locs[:] = [x for x in locs if x.url != loc.url]
            if not locs:
                del self._vid_map[int(vid)]

    async def _keep_connected(self) -> None:
        i = 0
        # full-jitter exponential backoff between reconnect rounds: a
        # fixed 1s cadence from a whole fleet of watchers re-dials a
        # rebooting master in lockstep (resilience.Backoff resets once
        # a stream delivers its snapshot)
        backoff = Backoff(base=0.25, cap=10.0)
        while True:
            master = self.current_master
            redirected = False
            self._stream_synced = False
            try:
                await self._consume_stream(master)
                glog.V(1).infof("masterclient %s: watch stream to %s "
                                "ended", self.name, master)
            except asyncio.CancelledError:
                raise
            except _LeaderRedirect:
                # _consume_stream already pointed current_master at the
                # announced leader; follow it instead of rotating, but
                # pause briefly so mutually-redirecting masters (election
                # window) can't drive a tight reconnect loop
                redirected = True
                await asyncio.sleep(0.2)
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                    RuntimeError, ValueError) as e:
                # ValueError covers a malformed NDJSON line; a swallowed
                # stream death must at least be visible at -v 1
                glog.V(1).infof("masterclient %s: watch stream to %s "
                                "failed: %s", self.name, master, e)
            except Exception as e:  # noqa: BLE001 — the watcher must
                # NEVER die: an unexpected update shape (KeyError in
                # _apply, non-dict JSON) would otherwise kill this task
                # silently and freeze the vid map for the process life
                glog.warning("masterclient %s: watch stream to %s: "
                             "unexpected %s: %s", self.name, master,
                             type(e).__name__, e)
            if self._stream_synced:
                backoff.reset()     # that stream was healthy once
            if not redirected:
                # rotate to the next configured master (leader chasing:
                # tryConnectToMaster redirect loop)
                i += 1
                self.current_master = self.masters[i % len(self.masters)]
                await asyncio.sleep(backoff.next())

    async def _consume_stream(self, master: str) -> None:
        await failpoints.fail("masterclient.watch")
        async with self._session.get(
                tls.url(master, "/cluster/watch")) as resp:
            if resp.status != 200:
                raise RuntimeError(f"watch {master}: {resp.status}")
            # fresh connect: rebuild from the snapshot the stream opens
            # with, dropping state from the previous (dead) connection
            self._vid_map.clear()
            buf = b""
            async for chunk, _ in resp.content.iter_chunks():
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    update = json.loads(line)
                    if update.get("synced"):
                        # end-of-snapshot marker: map is now complete
                        self._synced.set()
                        self._stream_synced = True
                        continue
                    if update.get("leader"):
                        # explicit leader hint (sent by non-leader masters
                        # in an HA deployment): reconnect there, and fold
                        # the learned leader into the rotation so its own
                        # later death still rotates through every master
                        # this client ever met
                        lead = update["leader"]
                        if lead not in self.masters:
                            self.masters.append(lead)
                        self.current_master = lead
                        raise _LeaderRedirect(lead)
                    self._apply(update)
