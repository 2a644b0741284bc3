"""A cell's cluster: the port's master and volume servers in this
process, started through the port's own entry points (`cli.start_master`,
`cli.start_volume`), each daemon on an event loop and thread of its own,
as its own process would run it, with the default executor of its loop.

`Deployment.start` takes the source's directory as the set-up left it
(a store with all 14 shards of each EC volume mounted) and starts the
master and the servers (the source first). The source then unmounts
every volume's shards, so that they lie on its disk as `ec.encode`'s
generate step leaves them, and each volume in turn is mounted and
spread as `ec.encode` spreads it (the shell's
`ec_encode_volume(generate=False)`: /admin/ec/copy, delete_shards and
mount on every holder, so the shard map is `balancedEcDistribution`'s
alone; its last step, deleting the original volume, the set-up has
done). The spread must equal the configuration's `shard_map`. Then the
configuration's `lost_server`, which must hold 4 shards of every volume,
is stopped, its listeners and frame server closed, and set-up waits
until neither the master nor the source's location cache lists it.
`stop` stops the rest.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import urllib.request
from dataclasses import dataclass, field

# heartbeat pulse of the master and every server, in seconds: the master
# drops a server 3 pulses after its last heartbeat
PULSE_S = 1.0
# how long set-up waits for the lost server to leave the maps
LOST_WAIT_S = 60.0
CALL_S = 600.0


class Loop:
    """An event loop running on a thread of its own."""

    def __init__(self, name: str):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name=name, daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = CALL_S):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        try:
            self.run(self.loop.shutdown_default_executor(), 60)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(60)
            if not self.thread.is_alive():
                self.loop.close()


@dataclass
class Server:
    name: str
    loop: Loop
    vs: object
    recorder: object
    live: bool = True


@dataclass
class Deployment:
    """The cluster of a cell, and what set-up made of it."""
    master: Server | None = None
    servers: list = field(default_factory=list)      # source first
    # vid -> {server url: [shard ids]}, as the spread left it
    shard_map: dict = field(default_factory=dict)
    lost: Server | None = None
    split: dict = field(default_factory=dict)

    @property
    def source(self) -> Server:
        return self.servers[0]

    def survivors(self, vid: int) -> dict:
        """{shard id: path} of a volume's shard files on the live
        servers."""
        from seaweedfs_tpu_torch.ec.pipeline import to_ext
        out = {}
        for s in self.servers:
            if not s.live:
                continue
            ev = s.vs.store.ec_volumes.get(vid)
            if ev is not None:
                for sid in ev.shards:
                    out[sid] = ev.base_name + to_ext(sid)
        return out

    def start(self, cfg: dict, source_dir: str, work: str, backend: str,
              vids: list) -> None:
        from seaweedfs_tpu_torch import cli
        parser = cli.build_parser()
        t = time.perf_counter()
        mloop = Loop("bench-master")
        m, rec = mloop.run(cli.start_master(parser.parse_args([
            "master", "-port", "0", "-mdir", os.path.join(work, "m"),
            "-pulseSeconds", str(PULSE_S)])))
        self.master = Server("master", mloop, m, rec)
        for i in range(cfg["volume_servers"]):
            d = source_dir if i == 0 else os.path.join(work, f"v{i}")
            os.makedirs(d, exist_ok=True)
            loop = Loop(f"bench-volume{i}")
            vs, rec = loop.run(cli.start_volume(parser.parse_args([
                "volume", "-port", "0", "-dir", d, "-master", m.url,
                "-ecBackend", backend, "-max", str(cfg["max_volumes"]),
                "-cache.mem", str(cfg["needle_cache_bytes"] >> 20),
                "-ec.smallrecover", str(cfg["small_recover_bytes"]),
                "-pulseSeconds", str(PULSE_S)])))
            self.servers.append(Server(f"v{i}", loop, vs, rec))
            if not loop.run(vs.heartbeat_once()):
                raise RuntimeError(f"volume server {vs.url} not registered")
        store = self.source.vs.store
        if (store.ec_large_block, store.ec_small_block) != (
                cfg["large_block_bytes"], cfg["small_block_bytes"]):
            raise ValueError(
                f"the volume server lays EC volumes out in blocks of "
                f"{store.ec_large_block} and {store.ec_small_block} bytes; "
                f"the configuration asks for {cfg['large_block_bytes']} and "
                f"{cfg['small_block_bytes']}")
        self.split["cluster_start_s"] = time.perf_counter() - t

        t = time.perf_counter()
        shell = Loop("bench-shell")
        try:
            shell.run(_unmount(m.url, self.source.vs.url, vids))
            for vid in vids:
                got = shell.run(_spread(m.url, vid, self.source.vs.url))
                for s in self.servers:
                    s.loop.run(s.vs.heartbeat_once())
                self.shard_map[vid] = {u: sorted(ss) for u, ss
                                       in got["assignments"].items()}
        finally:
            shell.close()
        self._check_spread(vids, cfg["shard_map"])
        self.split["spread_s"] = time.perf_counter() - t

        t = time.perf_counter()
        self.lost = self._lost(vids, cfg["lost_server"])
        self.lost.loop.run(self.lost.vs.stop())
        self.lost.live = False
        self._wait_lost(vids, m.url)
        self.split["server_lost_s"] = time.perf_counter() - t

    def named_map(self, vid: int) -> dict:
        """A volume's spread by server name (v0 the source)."""
        names = {s.vs.url: s.name for s in self.servers}
        return {names[u]: ss for u, ss in self.shard_map[vid].items()}

    def _check_spread(self, vids: list, stated: dict) -> None:
        """Each volume's shards are mounted as ec.encode spread them, and
        the spread is the one the configuration states."""
        for vid in vids:
            mounted = {s.vs.url: sorted(s.vs.store.ec_volumes[vid].shards)
                       for s in self.servers
                       if vid in s.vs.store.ec_volumes}
            if mounted != self.shard_map[vid] or any(
                    vid in s.vs.store.volumes for s in self.servers):
                raise RuntimeError(f"volume {vid}: servers mount "
                                   f"{mounted}, ec.encode spread "
                                   f"{self.shard_map[vid]}")
            if self.named_map(vid) != stated[str(vid)]:
                raise RuntimeError(f"volume {vid}: ec.encode spread "
                                   f"{self.named_map(vid)}, the "
                                   f"configuration states "
                                   f"{stated[str(vid)]}")

    def _lost(self, vids: list, name: str) -> Server:
        """The server to stop: not the source, and 4 shards of every
        volume on it."""
        (s,) = [s for s in self.servers if s.name == name]
        if s is self.source or any(
                len(self.shard_map[v].get(s.vs.url, ())) != 4 for v in vids):
            raise RuntimeError(f"{name} is the source or does not hold 4 "
                               f"shards of every volume: {self.shard_map}")
        return s

    def _wait_lost(self, vids: list, master_url: str) -> None:
        """Until the master's lookup and the source's location cache
        list none of the lost server's shards."""
        gone = self.lost.vs.url
        deadline = time.monotonic() + LOST_WAIT_S
        while any(gone in urls for v in vids
                  for urls in _ec_lookup(master_url, v).values()):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the master still lists {gone} "
                                   f"{LOST_WAIT_S} s after it stopped")
            time.sleep(PULSE_S / 4)
        # the source's location cache (server/ec_locations.py): a map
        # looked up before the loss is re-resolved at once
        cache = self.source.vs._ec_locations
        for v in vids:
            locs = cache.get(v)
            if locs is None or any(gone in urls for urls in locs.values()):
                cache.invalidate(v)
                locs = cache.get(v)
            if locs is None or any(gone in urls for urls in locs.values()):
                raise RuntimeError(f"volume {v}: the source's location "
                                   f"cache still lists {gone}: {locs}")

    def stop(self) -> None:
        """Stop every daemon still running and close their loops; the
        first failure is raised once every step has been tried."""
        errors: list = []

        def attempt(fn, *args) -> None:
            try:
                fn(*args)
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append(e)

        for s in reversed(self.servers):
            if s.live:
                s.live = False
                attempt(s.loop.run, s.vs.stop())
        if self.master is not None:
            attempt(self.master.loop.run, self.master.vs.stop())
            attempt(self.master.loop.run, self._cancel_recorders())
        for s in self.servers + ([self.master] if self.master else []):
            attempt(s.loop.close)
        if errors:
            raise errors[0]

    async def _cancel_recorders(self) -> None:
        # the timeline recorder is one a process, on the loop of the
        # daemon that started it first: the master's
        for s in [self.master] + self.servers:
            if s.recorder is not None:
                s.recorder.cancel()


def _env(master_url: str):
    from seaweedfs_tpu_torch.shell.env import CommandEnv

    class Env(CommandEnv):
        async def node_post(self, url: str, path: str, **params) -> dict:
            # ec.encode's last step deletes the original volume, which
            # the set-up (benchmark/build.py) deleted already
            if path == "/admin/volume/delete":
                return {"ok": True}
            return await super().node_post(url, path, **params)

    return Env(master_url)


async def _unmount(master_url: str, source_url: str, vids: list) -> None:
    """Every volume's shards off the source's mounts, its files kept: the
    state ec.encode's generate step leaves, in which shards not yet
    spread take none of the source's slots."""
    async with _env(master_url) as env:
        for vid in vids:
            await env.node_post(source_url, "/admin/ec/unmount",
                                volume=str(vid))


async def _spread(master_url: str, vid: int, source_url: str) -> dict:
    """Mount one volume's 14 shards on the source, then spread them as
    ec.encode does."""
    from seaweedfs_tpu_torch.shell.ec_commands import ec_encode_volume
    async with _env(master_url) as env:
        await env.node_post(source_url, "/admin/ec/mount", volume=str(vid))
        return await ec_encode_volume(env, vid, generate=False,
                                      locations=[source_url])


def _ec_lookup(master_url: str, vid: int) -> dict:
    with urllib.request.urlopen(
            f"http://{master_url}/vol/ec_lookup?volumeId={vid}",
            timeout=30) as r:
        return json.load(r).get("shards", {})
