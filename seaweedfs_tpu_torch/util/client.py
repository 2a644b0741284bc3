"""Async client SDK for the master/volume tier.

Reference: weed/operation/ (assign_file_id.go, upload_content.go,
lookup.go w/ 10-min vid cache, delete_content.go batch deletes) and
weed/wdclient/ (cached master client).

Resilience (beyond the reference): every hop runs under a RetryPolicy
(exponential backoff, full jitter, deadlines, shared retry budget) and
a per-upstream CircuitBreaker (util/resilience.py), and reads stream
with mid-flight replica failover — a volume server dying mid-body
rotates to the next location and resumes via a Range request instead
of failing the read.

A copy of seaweedfs_tpu/util/client.py in the PyTorch port, with one
change: a whole-needle read's frame leg takes FrameHub.pick's channel,
spread over the workers of a `-workers` fleet.
"""

from __future__ import annotations

from ..security import tls
from . import failpoints, tracing
from .resilience import BreakerRegistry, RetryBudget, RetryPolicy
from .singleflight import SingleFlight

import asyncio
import json
import time

import aiohttp


class OperationError(Exception):
    """`retryable=True` marks failures a caller can sensibly retry at
    a HIGHER level (fresh assign, different upstream): transport
    errors, 5xx exhaustion, open circuits — never 4xx."""

    def __init__(self, msg: object, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


# Per-request timeouts: connect must fail fast (a dead peer's SYN
# blackhole), sock_read guards mid-transfer stalls, and total stays
# unbounded for genuinely large streaming bodies — the old single
# total=120 session timeout let one stalled peer wedge an upload for
# two minutes.
MASTER_TIMEOUT = aiohttp.ClientTimeout(total=30, connect=5, sock_read=15)
DATA_TIMEOUT = aiohttp.ClientTimeout(total=None, connect=10, sock_read=60)


def parse_master_seeds(master_url: str) -> list[str]:
    """Comma-separated master seed list (shared with the volume
    server's heartbeat client)."""
    return [m.strip() for m in master_url.split(",") if m.strip()]


class WeedClient:
    def __init__(self, master_url: str,
                 session: aiohttp.ClientSession | None = None,
                 lookup_cache_ttl: float = 600.0,
                 jwt_key: str = "",
                 retry: RetryPolicy | None = None,
                 breakers: BreakerRegistry | None = None,
                 chunk_cache=None,
                 negative_lookup_ttl: float = 1.0):
        # comma-separated seed list: like the reference's wdclient, a
        # dead master must not strand the client — master requests
        # rotate through the surviving seeds (masterclient.go:45-119)
        self.master_seeds = parse_master_seeds(master_url)
        # empty input keeps the raw string and fails on first use, like
        # the pre-seed-list behavior
        self.master_url = (self.master_seeds[0] if self.master_seeds
                           else master_url)
        self._session = session
        self._own = session is None
        self._vid_cache: dict[str, tuple[float, list[dict]]] = {}
        self._cache_ttl = lookup_cache_ttl
        # when the cluster enforces write JWTs, co-deployed components
        # (filer, chunk GC) mint their own tokens with the shared key
        self.jwt_key = jwt_key
        self._master_client = None  # optional wdclient (attach_master_client)
        self.budget = RetryBudget()
        self.retry = retry or RetryPolicy(max_attempts=4, base_delay=0.05,
                                          max_delay=2.0, total_timeout=30.0,
                                          budget=self.budget)
        self.breakers = breakers or BreakerRegistry(
            threshold=5, reset_timeout=5.0)
        # optional whole-chunk read cache (util/chunk_cache
        # TieredChunkCache): hot re-reads skip the volume-server hop;
        # upload/delete of a fid drop its entry so read-your-writes
        # holds through this client
        self.chunk_cache = chunk_cache
        # singleflight collapses concurrent duplicate work: one master
        # lookup per vid round, one chunk fetch per fid round
        self._lookup_sf = SingleFlight()
        self._chunk_sf = SingleFlight()
        # short-TTL negative lookup cache: a deleted/unknown volume
        # answers from memory instead of hammering the master on every
        # read; invalidated by assign (the vid may have just been grown)
        self.negative_lookup_ttl = negative_lookup_ttl
        self._neg_vids: dict[str, float] = {}
        from .chunk_cache import CacheCounters
        self._neg_counters = CacheCounters("lookup_neg")
        # persistent multiplexed frame channels to volume servers
        # (util/frame.py), lazily created by pipelined_read — reads
        # are open over frames exactly like the HTTP listeners
        self._frame_hub = None

    @staticmethod
    def _budget_key(upstream: str) -> str:
        """Retry-budget pool key: upstream + the requesting tenant's
        QoS class (set by the entry-tier admission middleware), so an
        abusive tenant hammering a flapping volume drains only its
        own pool — not the paying tenant's."""
        from .. import qos
        cls = qos.current_class()
        return f"{upstream}|{cls}" if cls else upstream

    async def __aenter__(self) -> "WeedClient":
        if self._session is None:
            self._session = tls.make_session(timeout=DATA_TIMEOUT)
        return self

    async def __aexit__(self, *exc) -> None:
        if self._frame_hub is not None:
            await self._frame_hub.close()
            self._frame_hub = None
        if self._own and self._session:
            await self._session.close()

    @property
    def http(self) -> aiohttp.ClientSession:
        assert self._session is not None
        return self._session

    # ---- assign / lookup ----

    async def assign(self, count: int = 1, collection: str = "",
                     replication: str = "", ttl: str = "",
                     data_center: str = "") -> dict:
        params = {"count": str(count)}
        if collection:
            params["collection"] = collection
        if replication:
            params["replication"] = replication
        if ttl:
            params["ttl"] = ttl
        if data_center:
            params["dataCenter"] = data_center
        body = await self._master_get("/dir/assign", params)
        if "error" in body:
            raise OperationError(f"assign: {body['error']}")
        fid = body.get("fid", "")
        if fid:
            # the assign may have just grown this volume: a lingering
            # negative lookup entry would 404 the immediate read-back
            self._neg_vids.pop(fid.split(",")[0], None)
        return body

    async def _master_get(self, path: str, params: dict) -> dict:
        """GET against the current master, rotating through the seed
        list when the master is unreachable (a killed leader must not
        strand single-seed-configured clients mid-failover); unreachable
        rounds retry with backoff under the policy, and each seed sits
        behind its own circuit breaker so a long-dead master costs
        microseconds, not connect timeouts."""
        last: object = None
        sp = tracing.start("client", path.rsplit("/", 1)[-1] or "master")
        headers: dict = {}
        if sp:
            tracing.inject(headers, sp)
        attempt = 0
        try:
            async for _ in self.retry.attempts(self._budget_key("master")):
                attempt += 1
                if attempt > 1:
                    sp.event("retry", attempt=attempt)
                for _ in range(max(1, len(self.master_seeds))):
                    br = self.breakers.get(f"master:{self.master_url}")
                    if not br.allow():
                        last = last or \
                            f"master {self.master_url} circuit open"
                        sp.event("breaker_open", upstream=self.master_url)
                        self._rotate_seed()
                        continue
                    try:
                        await failpoints.fail("client.master_get")
                        framed = await self._frame_json(
                            self.master_url, "GET", path,
                            params=params, headers=headers,
                            timeout=30.0)
                        if framed is not None:
                            status, rh, body = framed
                            if status in (307, 502, 503):
                                # follower/no-leader answer: frames
                                # carry the redirect as data (no
                                # aiohttp auto-follow), so chase the
                                # explicit leader hint ourselves
                                last = body.get(
                                    "error", f"frame {status}") \
                                    if isinstance(body, dict) \
                                    else f"frame {status}"
                                br.record_success()
                                hb = body if isinstance(body, dict) \
                                    else {}
                                hint = (hb.get("leader", "")
                                        or rh.get("X-Raft-Leader", "")
                                        or rh.get("x-raft-leader", ""))
                                if hint and hint != self.master_url:
                                    sp.event("leader_hint",
                                             leader=hint)
                                    self.master_url = hint
                                else:
                                    sp.event("seed_rotate",
                                             status=status)
                                    self._rotate_seed()
                                continue
                            br.record_success()
                            sp.status = "ok"
                            return body
                        async with self.http.get(
                                tls.url(self.master_url, path),
                                params=params, headers=headers,
                                timeout=MASTER_TIMEOUT) as resp:
                            body = await resp.json()
                            if resp.status in (502, 503):
                                # no leader yet / quorum lost: chase an
                                # explicit leader hint when the reply
                                # carries one (X-Raft-Leader rides every
                                # follower answer), else the NEXT seed
                                # may already be the new leader
                                last = body.get("error",
                                                f"http {resp.status}")
                                br.record_success()  # reachable, not broken
                                hint = (body.get("leader", "")
                                        or resp.headers.get(
                                            "X-Raft-Leader", ""))
                                if hint and hint != self.master_url:
                                    sp.event("leader_hint", leader=hint)
                                    self.master_url = hint
                                else:
                                    sp.event("seed_rotate",
                                             status=resp.status)
                                    self._rotate_seed()
                                continue
                            if resp.history and resp.url.port:
                                # a follower 307'd us to the leader:
                                # remember it so the next request goes
                                # straight there (no redirect hop)
                                self._learn_master(
                                    f"{resp.url.host}:{resp.url.port}")
                            br.record_success()
                            sp.status = "ok"
                            return body
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError) as e:
                        last = e
                        br.record_failure()
                        sp.event("seed_rotate",
                                 error=f"{type(e).__name__} {e}"[:120])
                        self._rotate_seed()
            sp.status = "error"
            raise OperationError(f"master unreachable: {last}")
        finally:
            sp.finish()

    def _rotate_seed(self) -> None:
        if len(self.master_seeds) > 1:
            i = (self.master_seeds.index(self.master_url)
                 if self.master_url in self.master_seeds else -1)
            self.master_url = self.master_seeds[
                (i + 1) % len(self.master_seeds)]

    def _learn_master(self, leader: str) -> None:
        """Adopt a leader learned from a 307/hint; fold it into the
        seed rotation so a later death of THIS leader still rotates
        through every master we ever met."""
        if not leader:
            return
        if leader not in self.master_seeds:
            self.master_seeds.append(leader)
        self.master_url = leader

    def attach_master_client(self, mc) -> None:
        """Route lookups through a watch-fed MasterClient
        (wdclient/masterclient.go) instead of per-vid HTTP requests."""
        self._master_client = mc

    async def lookup(self, vid: str) -> list[dict]:
        """Volume locations with a TTL cache (lookup.go:10min), a
        short-TTL negative cache, and singleflight: N concurrent misses
        for one vid cost one master round trip, and reads of a
        deleted/unknown volume stop hammering the master for the
        negative TTL."""
        mc = getattr(self, "_master_client", None)
        if mc is not None:
            try:
                vid_num = int(vid)
            except ValueError as e:
                raise OperationError(f"lookup: bad volume id {vid!r}") from e
            locs = mc.lookup(vid_num)
            if locs:
                return [{"url": loc.url, "publicUrl": loc.public_url}
                        for loc in locs]
        hit = self._vid_cache.get(vid)
        now = time.time()
        if hit and now - hit[0] < self._cache_ttl:
            return hit[1]
        neg_until = self._neg_vids.get(vid)
        if neg_until is not None:
            if now < neg_until:
                self._neg_counters.hit(0)
                raise OperationError(
                    f"lookup {vid}: volume not found (negative-cached)")
            self._neg_vids.pop(vid, None)
        return await self._lookup_sf.do(vid,
                                        lambda: self._lookup_master(vid))

    async def _lookup_master(self, vid: str) -> list[dict]:
        self._neg_counters.miss()
        body = await self._master_get("/dir/lookup", {"volumeId": vid})
        if "locations" not in body:
            # authoritative miss from a reachable master: negative-cache
            # it (transport failures raise in _master_get and are NOT
            # cached — the volume may be perfectly fine). Bounded: a
            # client probing many distinct dead vids must not grow the
            # dict forever — sweep expired entries, then oldest.
            if len(self._neg_vids) >= 1024:
                now = time.time()
                self._neg_vids = {k: t for k, t in self._neg_vids.items()
                                  if t > now}
                while len(self._neg_vids) >= 1024:
                    self._neg_vids.pop(next(iter(self._neg_vids)))
            self._neg_vids[vid] = time.time() + self.negative_lookup_ttl
            raise OperationError(f"lookup {vid}: {body.get('error')}")
        self._vid_cache[vid] = (time.time(), body["locations"])
        self._neg_vids.pop(vid, None)
        return body["locations"]

    def invalidate(self, vid: str) -> None:
        self._vid_cache.pop(vid, None)
        self._neg_vids.pop(vid, None)

    async def lookup_file_id(self, fid: str) -> str:
        vid = fid.split(",")[0]
        locs = await self.lookup(vid)
        return tls.url(locs[0]['publicUrl'], f"/{fid}")

    # ---- data ops ----

    def _mint_jwt(self, fid: str) -> str:
        if not self.jwt_key:
            return ""
        from ..security.jwt import gen_jwt
        return gen_jwt(self.jwt_key, fid)

    async def upload(self, fid: str, url: str, data: bytes,
                     mime: str = "", ttl: str = "",
                     auth: str = "") -> dict:
        """Upload with bounded retries: 5xx and transport errors back
        off and retry (the write is idempotent — same fid, same bytes);
        4xx fail immediately. The volume upstream sits behind a
        breaker so a dead server sheds load fast."""
        params = {"ttl": ttl} if ttl else {}
        headers = {"Content-Type": mime} if mime else {}
        token = auth or self._mint_jwt(fid)
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if self.chunk_cache is not None:
            # same-fid overwrite: drop BEFORE the write so reads issued
            # from now on can't hit the old bytes. A second drop AFTER
            # the write succeeds (below) closes the other window — a
            # fetch that started during the POST's round trip read the
            # old body from the server and would otherwise re-pin it.
            self.chunk_cache.delete(fid)
        sp = tracing.start("client", "upload", fid=fid, upstream=url)
        if sp:
            tracing.inject(headers, sp)
        br = self.breakers.get(url)
        last: object = None
        attempt = 0
        try:
            async for _ in self.retry.attempts(self._budget_key(url)):
                attempt += 1
                if attempt > 1:
                    sp.event("retry", attempt=attempt)
                if not br.allow():
                    last = last or f"upload {fid}: {url} circuit open"
                    sp.event("breaker_open", upstream=url)
                    break
                try:
                    await failpoints.fail("client.upload")
                    framed = await self._frame_json(
                        url, "POST", f"/{fid}", params=params,
                        headers=headers, body=data, timeout=60.0)
                    if framed is not None:
                        status, _, body = framed
                    else:
                        async with self.http.post(
                                tls.url(url, f"/{fid}"), data=data,
                                params=params, headers=headers,
                                timeout=DATA_TIMEOUT) as resp:
                            body = await resp.json()
                            status = resp.status
                    if status in (200, 201):
                        br.record_success()
                        if self.chunk_cache is not None:
                            self.chunk_cache.delete(fid)
                        sp.status = "ok"
                        sp.nbytes = len(data)
                        return body
                    if status < 500:
                        br.record_success()  # server healthy, we erred
                        sp.status = str(status)
                        raise OperationError(f"upload {fid}: {body}")
                    last = f"upload {fid}: {body}"
                    br.record_failure()
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError, ValueError) as e:
                    last = f"upload {fid}: {type(e).__name__} {e}"
                    br.record_failure()
            sp.status = "error"
            raise OperationError(str(last), retryable=True)
        finally:
            sp.finish()

    async def upload_manifest(self, fid: str, url: str, manifest,
                              ttl: str = "", auth: str = "") -> dict:
        """Store a ChunkManifest needle (?cm=true marks the flag;
        operation/submit.go:222, needle_parse_multipart.go:86)."""
        params = {"cm": "true"}
        if ttl:
            params["ttl"] = ttl
        headers = {"Content-Type": "application/json"}
        token = auth or self._mint_jwt(fid)
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if self.chunk_cache is not None:
            # same drop-before/drop-after discipline as upload(): a
            # manifest overwrite of a cached fid must not serve the
            # pre-overwrite bytes, and a fetch racing the POST's round
            # trip must not re-pin them afterwards
            self.chunk_cache.delete(fid)
        await failpoints.fail("client.upload_manifest")
        async with self.http.post(tls.url(url, f"/{fid}"),
                                  data=manifest.marshal(),
                                  params=params, headers=headers,
                                  timeout=DATA_TIMEOUT) as resp:
            body = await resp.json()
            if resp.status not in (200, 201):
                raise OperationError(f"upload manifest {fid}: {body}")
            if self.chunk_cache is not None:
                self.chunk_cache.delete(fid)
            return body

    async def upload_data(self, data: bytes, collection: str = "",
                          replication: str = "", ttl: str = "",
                          mime: str = "", data_center: str = "") -> str:
        """assign + upload (forwarding the assign's write token); returns
        the fid. A retryable upload failure (dead/open-circuit target)
        gets a FRESH assign — the master routes around the dead server
        within a pulse or two, so re-assigning is what keeps writes
        available through a node death instead of failing them fast."""
        last: OperationError | None = None
        for _ in range(3):
            a = await self.assign(collection=collection,
                                  replication=replication, ttl=ttl,
                                  data_center=data_center)
            try:
                await self.upload(a["fid"], a["url"], data, mime=mime,
                                  ttl=ttl, auth=a.get("auth", ""))
                return a["fid"]
            except OperationError as e:
                if not e.retryable:
                    raise
                last = e
        raise last

    async def read_stream(self, fid: str, offset: int = 0,
                          size: int = -1):
        """Cached-or-network chunk stream: when a chunk cache is
        attached and holds this fid's whole body, the requested range
        is sliced from memory and the volume-server hop is skipped
        entirely; otherwise the degraded-read network path below runs
        unchanged."""
        cc = self.chunk_cache
        if cc is not None:
            data = await self._cc_get(fid)
            if data is not None:
                end = len(data) if size < 0 else min(len(data),
                                                     offset + size)
                for pos in range(offset, end, 1 << 16):
                    yield data[pos:min(pos + (1 << 16), end)]
                return
        async for chunk in self._read_stream_net(fid, offset, size):
            yield chunk

    async def _cc_get(self, fid: str) -> bytes | None:
        """Chunk-cache lookup that keeps mmap disk-tier I/O off the
        event loop — a cold-page 4MB slice would otherwise block every
        request on the daemon behind its page faults."""
        cc = self.chunk_cache
        if cc.has_disk:
            return await tracing.run_in_executor(cc.get, fid)
        return cc.get(fid)

    async def chunk_bytes(self, fid: str, size: int = -1) -> bytes:
        """Whole-chunk read through the cache, with singleflight: N
        concurrent readers of one cold chunk trigger ONE volume-server
        fetch; everyone shares the bytes (filer/S3/WebDAV hot path)."""
        cc = self.chunk_cache
        if cc is None:
            return await self.read(fid, 0, size)
        data = await self._cc_get(fid)
        if data is not None:
            return data
        # token BEFORE the fetch, and IN the singleflight key: a fill
        # that raced an overwrite/delete is refused by set_if, and a
        # reader arriving AFTER an acknowledged write starts a fresh
        # round instead of joining the stale in-flight one (the old
        # round only serves callers that began before the write
        # completed — a legal serialization)
        token = cc.fill_token(fid)

        async def fetch() -> bytes:
            parts = []
            async for chunk in self._read_stream_net(fid, 0, size):
                parts.append(chunk)
            blob = b"".join(parts)
            if cc.has_disk:
                # mmap writes for disk-routed sizes: executor, not loop
                await tracing.run_in_executor(cc.set_if, fid, blob,
                                              token)
            else:
                cc.set_if(fid, blob, token)
            return blob

        return await self._chunk_sf.do((fid, token), fetch)

    async def _read_stream_net(self, fid: str, offset: int = 0,
                               size: int = -1):
        """Async-generate the bytes of a needle with DEGRADED-READ
        FAILOVER: every holder from the lookup is tried; a holder that
        dies MID-BODY does not fail the read — the stream rotates to
        the next location and resumes from the exact byte reached, via
        a Range request. On a full miss the cached locations are
        invalidated and one fresh lookup retries (a killed server stays
        in the 10-min vid cache otherwise). Open breakers demote a
        location to last place rather than skipping it outright — shed
        load first, but never turn a readable file into an error.

        A clean short body (server's Content-Length honored) ends the
        stream normally — sparse/short chunks stay the caller's
        zero-fill business, exactly as before.

        The whole read is one client-tier span; every replica rotation,
        mid-body Range resume, breaker demotion and lookup refresh is a
        span event, so a degraded read's recovery dance is visible in
        the trace instead of only in aggregate counters. The span is
        finished in the generator's finally (an abandoned stream still
        records what it did). NOT entered as a context manager: an
        async generator body runs in its consumer's context, so a
        contextvar set here could leak into (or fail to reset from) a
        different task — the volume hop is parented via the explicit
        traceparent header instead."""
        sp = tracing.start("client", "read", fid=fid)
        vid = fid.split(",")[0]
        sent = 0                    # bytes already yielded
        last: str = "no locations"
        stalled = 0
        tries = 0
        try:
            while stalled < 2:
                # keep rotating while bytes ADVANCE (every replica may be
                # flaky under injected faults); give up only after two
                # consecutive lookup rounds with zero forward progress
                round_start = sent
                try:
                    locs = await self.lookup(vid)
                except OperationError as e:
                    last = str(e)
                    break
                # blocking() is a side-effect-free peek — allow() here
                # would consume half-open probes for locations the read
                # may never touch, wedging recovered upstreams half-open
                locs = sorted(locs, key=lambda l: self.breakers.get(
                    l.get("publicUrl", l.get("url", ""))).blocking())
                for loc in locs:
                    upstream = loc.get("publicUrl", loc.get("url", ""))
                    url = tls.url(upstream, f"/{fid}")
                    br = self.breakers.get(upstream)
                    cur = offset + sent
                    headers = {}
                    if sp:
                        tracing.inject(headers, sp)
                    tries += 1
                    if tries > 1:
                        # a second holder is only tried after the first
                        # failed: this IS the replica failover, resuming
                        # from the exact byte reached when mid-body
                        sp.event("replica_rotate", upstream=upstream,
                                 resume_at=cur, last=str(last)[:120])
                    if cur or size >= 0:
                        end = "" if size < 0 else str(offset + size - 1)
                        headers["Range"] = f"bytes={cur}-{end}"
                        if sent and tries > 1:
                            sp.event("range_resume", at=cur)
                    else:
                        # whole-needle fast path: one round trip on the
                        # persistent frame channel to this holder.
                        # Ranged and mid-body-resumed reads always ride
                        # HTTP (Range is an HTTP-leg contract); any
                        # frame failure or non-authoritative status
                        # drops to the HTTP leg below, which keeps
                        # owning breakers, rotation and retries
                        from .frame import FrameChannelError
                        status = None
                        try:
                            # chaos site: worker.frame severs this leg
                            await failpoints.fail("worker.frame")
                            chan = self.frame_hub.pick(upstream)
                            status, _, fbody = await chan.request(
                                "GET", f"/{fid}", headers=headers,
                                timeout=30.0)
                        except (FrameChannelError,
                                asyncio.TimeoutError, OSError):
                            status = None
                        if status in (404, 410):
                            br.record_success()
                            sp.status = "404"
                            raise OperationError(
                                f"read {fid}: not found")
                        if status == 200:
                            for pos in range(0, len(fbody), 1 << 16):
                                chunk = fbody[pos:pos + (1 << 16)]
                                sent += len(chunk)
                                yield chunk
                            br.record_success()
                            sp.status = "ok"
                            return
                    try:
                        await failpoints.fail("client.read")
                        async with self.http.get(
                                url, headers=headers,
                                timeout=DATA_TIMEOUT) as resp:
                            if resp.status in (404, 410):
                                # authoritative: the holder says gone
                                br.record_success()
                                sp.status = "404"
                                raise OperationError(
                                    f"read {fid}: not found")
                            if resp.status >= 400:
                                # an error body must never masquerade as
                                # file content; 5xx => try the next holder
                                body = await resp.read()
                                last = (f"http {resp.status} "
                                        f"{body[:200].decode(errors='replace')}")
                                if resp.status >= 500:
                                    br.record_failure()
                                else:
                                    br.record_success()
                                continue
                            # server ignored Range (200 to a mid-file
                            # resume): skip the delivered prefix
                            skip = cur if resp.status == 200 else 0
                            async for chunk in resp.content.iter_chunked(
                                    1 << 16):
                                if skip:
                                    if len(chunk) <= skip:
                                        skip -= len(chunk)
                                        continue
                                    chunk = chunk[skip:]
                                    skip = 0
                                if size >= 0:
                                    remain = size - sent
                                    if len(chunk) > remain:
                                        chunk = chunk[:remain]
                                if chunk:
                                    sent += len(chunk)
                                    yield chunk
                                if size >= 0 and sent >= size:
                                    break
                            br.record_success()
                            sp.status = "ok"
                            return
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError) as e:
                        # mid-body deaths land here (aiohttp raises
                        # ClientPayloadError when the peer dies before
                        # Content-Length is satisfied): rotate + resume
                        last = f"{type(e).__name__} {e}"
                        br.record_failure()
                        continue
                stalled = stalled + 1 if sent == round_start else 0
                self.invalidate(vid)    # stale holders: refresh + retry
                sp.event("lookup_refresh", stalled=stalled)
            sp.status = sp.status or "error"
            raise OperationError(f"read {fid}: {last}")
        finally:
            sp.finish(nbytes=sent)

    async def read(self, fid: str, offset: int = 0,
                   size: int = -1) -> bytes:
        """Read with location failover (buffered form of read_stream).
        Whole-needle reads route through the chunk cache + singleflight
        when one is attached."""
        if self.chunk_cache is not None and offset == 0 and size < 0:
            return await self.chunk_bytes(fid)
        parts = []
        async for chunk in self.read_stream(fid, offset, size):
            parts.append(chunk)
        return b"".join(parts)

    async def batch_read(self, fids: list[str], batch_max: int = 64
                         ) -> dict[str, bytes | None]:
        """Multi-needle GET: group fids by holding server and resolve
        each group with `/batch` round trips (util/batchframe framing)
        instead of one request per needle — the per-request overhead
        amortization the volume tier's unified wire provides. Rows the
        batch endpoint can't serve (chunked manifests, transient
        errors) and servers without the endpoint fall back to the
        resilient single-GET path; a fid that ultimately can't be read
        maps to None (callers decide whether that's fatal).

        Cache-aware: attached chunk-cache hits skip the network, and
        fetched whole bodies fill the cache under the same fill-token
        fencing chunk_bytes uses."""
        result: dict[str, bytes | None] = {}
        cc = self.chunk_cache
        by_server: dict[str, list[str]] = {}
        sp = tracing.start("client", "batch_read", n=len(fids))
        try:
            for fid in dict.fromkeys(fids):   # dedup, order-stable
                if cc is not None:
                    data = await self._cc_get(fid)
                    if data is not None:
                        result[fid] = data
                        continue
                try:
                    locs = await self.lookup(fid.split(",")[0])
                except OperationError:
                    result[fid] = None
                    continue
                url = locs[0].get("publicUrl", locs[0].get("url", ""))
                by_server.setdefault(url, []).append(fid)

            async def fallback(fid: str) -> None:
                try:
                    result[fid] = await self.read(fid)
                except OperationError:
                    result[fid] = None

            async def one_server(server: str, group: list[str]) -> None:
                for lo in range(0, len(group), batch_max):
                    chunk = group[lo:lo + batch_max]
                    # fill tokens snapshotted BEFORE the fetch, like
                    # chunk_bytes: a fid overwritten/deleted while the
                    # /batch response is in flight bumps its gen and
                    # set_if refuses the stale fill
                    tokens = ({f: cc.fill_token(f) for f in chunk}
                              if cc is not None else {})
                    rows: list | None = None
                    try:
                        await failpoints.fail("client.batch_read")
                        async with self.http.get(
                                tls.url(server, "/batch"),
                                params={"fids": ",".join(chunk)},
                                timeout=DATA_TIMEOUT) as resp:
                            if resp.status == 200:
                                from .batchframe import parse_all
                                rows = parse_all(await resp.read())
                    except (aiohttp.ClientError, asyncio.TimeoutError,
                            OSError, ValueError):
                        rows = None
                    if rows is None or len(rows) != len(chunk):
                        # endpoint unavailable / torn payload: the
                        # whole chunk takes the single-GET path
                        sp.event("batch_fallback", server=server,
                                 n=len(chunk))
                        for fid in chunk:
                            await fallback(fid)
                        continue
                    for fid, (meta, body) in zip(chunk, rows):
                        if meta.get("status") == 200:
                            if meta.get("gzip"):
                                import gzip as _gzip
                                body = _gzip.decompress(body)
                            if cc is not None:
                                if cc.has_disk:
                                    await tracing.run_in_executor(
                                        cc.set_if, fid, body,
                                        tokens[fid])
                                else:
                                    cc.set_if(fid, body, tokens[fid])
                            result[fid] = body
                        elif meta.get("status") == 404:
                            result[fid] = None
                        else:
                            # 406 manifest / transient 5xx: single GET
                            await fallback(fid)

            await asyncio.gather(*(one_server(s, g)
                                   for s, g in by_server.items()))
            sp.status = "ok"
            return {fid: result.get(fid) for fid in fids}
        finally:
            sp.finish()

    @property
    def frame_hub(self):
        """Lazily-built cache of persistent multiplexed frame channels
        (util/frame.FrameHub) — one per volume server this client has
        pipelined against; closed with the session in __aexit__."""
        if self._frame_hub is None:
            from .frame import FrameHub
            self._frame_hub = FrameHub(ssl=tls.client_ctx(),
                                       jwt_key=self.jwt_key)
        return self._frame_hub

    async def _frame_json(self, server: str, method: str, path: str,
                          params: dict | None = None,
                          headers: dict | None = None,
                          body: bytes = b"",
                          timeout: float = 30.0):
        """One request over the persistent frame channel to `server`,
        answer parsed as JSON: (status, headers, body-dict), or None
        when the frame leg is unavailable (peer predates frames,
        severed channel, open breaker, FLAG_FALLBACK) and the caller
        should ride the resilient HTTP path. Never raises — HTTP is
        the leg whose failures drive retry/breaker bookkeeping."""
        from .frame import FrameChannelError
        try:
            # chaos site: worker.frame (also armed inside the channel
            # send itself) severs this frame leg so every caller's
            # HTTP fallback is exercised
            await failpoints.fail("worker.frame")
            chan = self.frame_hub.get(target=server)
            status, rheaders, raw = await chan.request(
                method, path, query=params, headers=headers,
                body=body, timeout=timeout)
            return status, rheaders, json.loads(raw or b"{}")
        except (FrameChannelError, asyncio.TimeoutError, OSError,
                ValueError):
            return None

    async def pipelined_read(self, fids: list[str], depth: int = 8
                             ) -> dict[str, bytes | None]:
        """Pipelined multi-needle read: up to `depth` requests in
        flight per keep-alive frame connection (util/frame.py), so a
        needle costs tens of bytes of protocol overhead and no
        per-request round-trip wait — responses complete out of order
        and the socket stays full. Complements batch_read: /batch
        amortizes one response over many needles, pipelining overlaps
        many independent responses (and never waits for the slowest
        row in a batch).

        Any channel-level failure (peer predates the frame protocol,
        severed connection, FLAG_FALLBACK row) silently downgrades
        that fid to the resilient single-GET HTTP path. Cache-aware
        exactly like batch_read: hits skip the network, fills are
        fence-tokened. A fid that ultimately can't be read maps to
        None."""
        from .frame import FrameChannelError
        result: dict[str, bytes | None] = {}
        cc = self.chunk_cache
        by_server: dict[str, list[str]] = {}
        sp = tracing.start("client", "pipelined_read", n=len(fids),
                           depth=depth)
        try:
            for fid in dict.fromkeys(fids):   # dedup, order-stable
                if cc is not None:
                    data = await self._cc_get(fid)
                    if data is not None:
                        result[fid] = data
                        continue
                try:
                    locs = await self.lookup(fid.split(",")[0])
                except OperationError:
                    result[fid] = None
                    continue
                url = locs[0].get("publicUrl", locs[0].get("url", ""))
                by_server.setdefault(url, []).append(fid)

            async def fallback(fid: str) -> None:
                try:
                    result[fid] = await self.read(fid)
                except OperationError:
                    result[fid] = None

            async def one_server(server: str, group: list[str]) -> None:
                chan = self.frame_hub.get(target=server)
                sem = asyncio.Semaphore(max(1, depth))
                fell_back = 0

                async def one(fid: str) -> None:
                    nonlocal fell_back
                    token = cc.fill_token(fid) if cc is not None \
                        else None
                    async with sem:
                        try:
                            await failpoints.fail("client.pipeline")
                            status, _, body = await chan.request(
                                "GET", "/" + fid, timeout=30.0)
                        except (FrameChannelError, OSError):
                            # dead channel / FLAG_FALLBACK / injected
                            # fault: this fid rides the HTTP path
                            fell_back += 1
                            await fallback(fid)
                            return
                    if status == 200:
                        if cc is not None:
                            if cc.has_disk:
                                await tracing.run_in_executor(
                                    cc.set_if, fid, body, token)
                            else:
                                cc.set_if(fid, body, token)
                        result[fid] = body
                    elif status == 404:
                        result[fid] = None
                    else:
                        # 406 manifest / transient 5xx: single GET
                        await fallback(fid)

                await asyncio.gather(*(one(f) for f in group))
                if fell_back:
                    sp.event("pipeline_fallback", server=server,
                             n=fell_back)

            await asyncio.gather(*(one_server(s, g)
                                   for s, g in by_server.items()))
            sp.status = "ok"
            return {fid: result.get(fid) for fid in fids}
        finally:
            sp.finish()

    async def delete_fids(self, fids: list[str]) -> int:
        """Batch delete grouped per volume server
        (delete_content.go DeleteFilesAtOneVolumeServer)."""
        by_server: dict[str, list[str]] = {}
        for fid in fids:
            if self.chunk_cache is not None:
                self.chunk_cache.delete(fid)
            try:
                locs = await self.lookup(fid.split(",")[0])
            except OperationError:
                continue
            for loc in locs:
                by_server.setdefault(loc["url"], []).append(fid)

        async def drop_one_by_one(server: str, batch: list[str]) -> int:
            n = 0
            for fid in batch:
                headers = {}
                token = self._mint_jwt(fid)
                if token:
                    headers["Authorization"] = f"Bearer {token}"
                try:
                    await failpoints.fail("client.delete")
                    async with self.http.delete(
                            tls.url(server, f"/{fid}"),
                            params={"type": "replicate"},
                            headers=headers,
                            timeout=DATA_TIMEOUT) as resp:
                        n += resp.status == 200
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError):
                    pass
            return n

        async def drop(server: str, batch: list[str]) -> int:
            # one round trip per holding server via the batch endpoint
            # (volume_grpc_batch_delete.go analog), with per-fid write
            # tokens when the cluster enforces them
            br = self.breakers.get(server)
            if not br.allow():
                return 0            # dead server: fail fast, not timeout
            payload: dict = {"fileIds": batch}
            if self.jwt_key:
                payload["tokens"] = {f: self._mint_jwt(f) for f in batch}
            try:
                await failpoints.fail("client.delete")
                framed = await self._frame_json(
                    server, "POST", "/admin/batch_delete",
                    headers={"content-type": "application/json"},
                    body=json.dumps(payload).encode(), timeout=30.0)
                if framed is not None:
                    br.record_success()
                    status, _, jbody = framed
                else:
                    async with self.http.post(
                            tls.url(server, "/admin/batch_delete"),
                            json=payload, timeout=DATA_TIMEOUT) as resp:
                        # the probe consumed by allow() MUST be
                        # resolved on every path — an unrecorded
                        # outcome wedges the breaker half-open forever
                        br.record_success()   # reachable (any status)
                        status = resp.status
                        jbody = (await resp.json()
                                 if status == 200 else {})
                if status == 200:
                    res = jbody.get("results", [])
                    ok = sum(r.get("status") in (200, 202)
                             for r in res)
                    # rows the batch mode cannot handle (406 chunk
                    # manifests, transient 5xx) still get the
                    # per-fid tombstone the old path gave them
                    retry = [r.get("fileId") for r in res
                             if r.get("status") in (406, 500, 503)]
                    if retry:
                        ok += await drop_one_by_one(server, retry)
                    return ok
            except (aiohttp.ClientError, asyncio.TimeoutError, OSError,
                    ValueError):
                br.record_failure()
            # endpoint unavailable: per-fid tombstones
            return await drop_one_by_one(server, batch)

        counts = await asyncio.gather(
            *(drop(s, b) for s, b in by_server.items()))
        if self.chunk_cache is not None:
            # second drop AFTER the tombstones landed: a fetch that
            # raced the deletes read the still-live body and would
            # otherwise re-pin a "deleted" chunk (see upload())
            for fid in fids:
                self.chunk_cache.delete(fid)
        return sum(counts)


class FilerHttpClient:
    """Shard-routing client for the filer metadata surface.

    Routes each path by longest-prefix match against the cached shard
    map, chases ``307 + X-Shard-Owner`` answers (bounded hops) and
    folds the learned owner into the route cache — the same learned-
    leader rotation discipline ``WeedClient._master_get`` applies to
    raft leadership. Used by tools/bench_meta.py and the meta soak;
    collapses to a plain filer client at 1 shard.
    """

    MAX_HOPS = 4

    def __init__(self, filers: list[str] | str, master_url: str = "",
                 timeout_s: float = 30.0):
        from ..filer.shard import RouteCache
        if isinstance(filers, str):
            filers = [f.strip() for f in filers.split(",") if f.strip()]
        if not filers:
            raise ValueError("FilerHttpClient needs at least one filer")
        self.filers = filers
        self.routes = RouteCache(master_url)
        self.timeout_s = timeout_s
        self.redirects_chased = 0
        self.session: aiohttp.ClientSession | None = None

    async def __aenter__(self) -> "FilerHttpClient":
        self.session = tls.make_session(
            timeout=aiohttp.ClientTimeout(total=self.timeout_s))
        if self.routes.master_seeds:
            await self.routes.refresh(self.session, force=True)
        return self

    async def __aexit__(self, *exc) -> None:
        if self.session is not None:
            await self.session.close()

    def _first_base(self, route_path: str) -> str:
        return self.routes.owner_for(route_path) or self.filers[0]

    async def request(self, method: str, path: str,
                      route_path: str | None = None,
                      params: dict | None = None,
                      data: bytes | None = None,
                      expect: tuple = (200, 201, 204)) -> dict:
        """One routed filer call. `route_path` is the namespace path
        the shard map routes on (defaults to `path` — pass it
        explicitly for /__api__/ calls whose URL is not the entry
        path). Raises OperationError on a non-`expect` terminal
        answer."""
        rp = route_path if route_path is not None else path
        base = self._first_base(rp)
        body: dict = {}
        for _ in range(self.MAX_HOPS):
            # chaos site: every routed metadata hop
            await failpoints.fail("filer.shard.route")
            async with self.session.request(
                    method, tls.url(base, path), params=params,
                    data=data, allow_redirects=False) as resp:
                if resp.status in (307, 302):
                    owner = resp.headers.get("X-Shard-Owner", "")
                    if not owner:
                        raise OperationError(
                            f"{method} {path}: redirect without "
                            f"X-Shard-Owner from {base}")
                    self.routes.learn(
                        resp.headers.get("X-Shard-Prefix", rp), owner,
                        int(resp.headers.get("X-Shard-Epoch", 0) or 0))
                    self.redirects_chased += 1
                    base = owner
                    continue
                if resp.content_type == "application/json":
                    body = await resp.json()
                else:
                    body = {"raw": await resp.read()}
                if resp.status == 503 and self.routes.master_seeds:
                    # owner unknown on that shard: refetch the map
                    # and retry (split window, registration race)
                    await asyncio.sleep(0.1)
                    await self.routes.refresh(self.session, force=True)
                    base = self._first_base(rp)
                    continue
                if resp.status not in expect:
                    raise OperationError(
                        f"{method} {path} -> {resp.status}: "
                        f"{body.get('error', '')}")
                return body
        raise OperationError(f"{method} {path}: shard redirect loop "
                             f"(> {self.MAX_HOPS} hops)")

    # -- the metadata ops the benchmarks drive -------------------------

    async def create(self, path: str, payload: bytes = b"x") -> dict:
        return await self.request("PUT", path, data=payload,
                                  expect=(201,))

    async def mkdir(self, path: str) -> dict:
        return await self.request("POST", path, params={"mkdir": "true"},
                                  expect=(201,))

    async def stat(self, path: str) -> dict:
        return await self.request("GET", "/__api__/lookup",
                                  route_path=path,
                                  params={"path": path})

    async def list_dir(self, path: str, start_file: str = "",
                       limit: int = 1024,
                       inclusive: bool = False) -> list[dict]:
        body = await self.request(
            "GET", "/__api__/list", route_path=path,
            params={"path": path, "startFile": start_file,
                    "inclusive": "true" if inclusive else "false",
                    "limit": str(limit)})
        return body.get("entries", [])

    async def rename(self, src: str, dst: str) -> dict:
        return await self.request("POST", "/__api__/rename",
                                  route_path=src,
                                  params={"from": src, "to": dst})

    async def delete(self, path: str, recursive: bool = False) -> dict:
        return await self.request(
            "DELETE", path,
            params={"recursive": "true"} if recursive else None)
