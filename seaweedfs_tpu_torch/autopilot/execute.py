"""Execute phase: turn a plan into paced, bounded, journaled repairs.

Repair traffic is a first-class consumer of cluster bandwidth (the
Facebook warehouse study, 1309.0186: ~180 TB/day median), so the
executor applies the same discipline the scrubber proved for reads,
now driving writes:

* **cluster-wide token bucket** (``-autopilot.mbps``): every action's
  conservative byte estimate is paid for BEFORE it dispatches, so
  sustained repair I/O can never exceed the operator's budget — the
  heal soak asserts the pacing floor from the ledger;
* **pause-on-page**: before each action the fleet's ``/debug/health``
  verdicts are consulted (cached a few seconds); while anything pages,
  repair parks — it must never bury a foreground incident under
  rebuild traffic. Parking past ``pause_max_s`` defers the rest of the
  cycle instead of wedging the loop;
* **bounded concurrency** + per-action retry/backoff
  (``util/resilience.RetryPolicy``) with ranked fallback targets, so a
  target that refuses (dead, partition-mismatched, full) doesn't kill
  the repair — the next-ranked candidate gets it;
* **leadership halt**: a deposed leader stops dispatching immediately
  (remaining actions come back ``halted``), because the new leader's
  autopilot owns the cluster now;
* **dry-run** (``-autopilot.dryrun``): the exact ledger, nothing sent.

Every outcome is journaled (``autopilot_action`` / ``autopilot_defer``
/ ``autopilot_pause`` events) and counted
(``SeaweedFS_autopilot_*``), so the flight recorder can replay why the
cluster healed the way it did.

A copy of seaweedfs_tpu/autopilot/execute.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import time

from ..ec.scrub import TokenBucket
from ..util import events, glog
from ..util.resilience import RetryPolicy
from .plan import (KIND_REBUILD, KIND_REPLICATE, KIND_TIER, KIND_VACUUM,
                   Action)

_PAUSE_POLL_S = 1.0


class ActionError(Exception):
    pass


class Executor:
    def __init__(self, node_post, *,
                 mbps: float = 16.0,
                 concurrency: int = 2,
                 dryrun: bool = False,
                 is_leader=None,
                 paging=None,
                 pause_max_s: float = 300.0,
                 sleep=asyncio.sleep):
        """`node_post(url, path, params, timeout_s) -> dict` is the one
        transport hook (controller wires it to the master's session;
        tests inject a recorder). `paging() -> bool` is async."""
        self.node_post = node_post
        self.mbps = mbps
        self.dryrun = dryrun
        self.concurrency = max(1, concurrency)
        self.is_leader = is_leader or (lambda: True)
        self.paging = paging
        self.pause_max_s = pause_max_s
        self._sleep = sleep
        self.bucket = TokenBucket(mbps * (1 << 20), sleep=sleep)
        self.paced_sleep_s = 0.0
        self.paused_s = 0.0
        self.bytes_paid = 0
        self.in_flight: dict = {}

    # ---- metrics (lazy, prometheus-optional) ---------------------------

    @staticmethod
    def _count(name: str, n: float = 1, labels: tuple = ()) -> None:
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        c = getattr(metrics, name)
        (c.labels(*labels) if labels else c).inc(n)

    @staticmethod
    def _gauge(name: str, v: float) -> None:
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        getattr(metrics, name).set(v)

    # ---- the paced dispatch loop ---------------------------------------

    async def execute(self, actions: "list[Action]") -> "list[dict]":
        """Run the ordered plan; returns one result row per action, in
        plan order. Pays the token bucket and consults the pause gate
        SEQUENTIALLY (pacing and priority stay meaningful), then runs
        the network work under bounded concurrency."""
        results: "list[dict]" = [None] * len(actions)  # type: ignore
        sem = asyncio.Semaphore(self.concurrency)
        tasks: "list[asyncio.Task]" = []
        halted_from = len(actions)
        self._gauge("AUTOPILOT_QUEUE_DEPTH", len(actions))
        for i, a in enumerate(actions):
            self._gauge("AUTOPILOT_QUEUE_DEPTH", len(actions) - i)
            if not self.is_leader():
                halted_from = i
                break
            # dry-run executes nothing, so it must also BLOCK on
            # nothing: no token-bucket sleeps (a 30 GB rebuild
            # estimate would park a forced ?run=1 cycle for minutes)
            # and no pause gate — the ledger still rides live order
            if not self.dryrun:
                paused = await self._pause_gate()
                if paused == "defer":
                    halted_from = i
                    for j in range(i, len(actions)):
                        results[j] = self._result(
                            actions[j], "deferred",
                            error="paused too long")
                        events.record("autopilot_defer",
                                      kind=actions[j].kind,
                                      vid=actions[j].vid,
                                      reason="paused-too-long")
                        self._count("AUTOPILOT_DEFERRALS",
                                    labels=("paused",))
                    break
                if not self.is_leader():
                    halted_from = i
                    break
                # pay for the action's bytes BEFORE it moves them
                self.paced_sleep_s += \
                    await self.bucket.consume(a.bytes_est)
                # paid = admitted through the bucket; a dry run admits
                # nothing and must not inflate the budget accounting
                self.bytes_paid += a.bytes_est

            async def run_one(idx: int, act: Action) -> None:
                async with sem:
                    results[idx] = await self._run_action(act)
            t = asyncio.ensure_future(run_one(i, a))
            tasks.append(t)
        if tasks:
            await asyncio.gather(*tasks)
        for j in range(halted_from, len(actions)):
            if results[j] is None:
                results[j] = self._result(actions[j], "halted",
                                          error="lost leadership")
                self._count("AUTOPILOT_DEFERRALS", labels=("halted",))
        self._gauge("AUTOPILOT_QUEUE_DEPTH", 0)
        return results

    async def _pause_gate(self) -> str:
        """Park while the fleet pages. Returns "ok" or "defer"."""
        if self.paging is None or not await self.paging():
            self._gauge("AUTOPILOT_PAUSED", 0)
            return "ok"
        events.record("autopilot_pause")
        self._count("AUTOPILOT_PAUSES")
        self._gauge("AUTOPILOT_PAUSED", 1)
        t0 = time.monotonic()
        while await self.paging():
            if time.monotonic() - t0 > self.pause_max_s:
                self._gauge("AUTOPILOT_PAUSED", 0)
                return "defer"
            self.paused_s += _PAUSE_POLL_S
            await self._sleep(_PAUSE_POLL_S)
        self._gauge("AUTOPILOT_PAUSED", 0)
        return "ok"

    def _result(self, a: Action, status: str, error: str = "",
                target: str = "", seconds: float = 0.0) -> dict:
        return {"action": a.to_dict(), "status": status,
                "error": error, "target": target or a.target,
                "seconds": round(seconds, 3),
                "wall_ms": round(time.time() * 1000.0, 3)}

    async def _run_action(self, a: Action) -> dict:
        self.in_flight[a.key()] = a.to_dict()
        t0 = time.monotonic()
        try:
            if self.dryrun:
                events.record("autopilot_action", kind=a.kind,
                              vid=a.vid, target=a.target, dryrun=True,
                              reason=a.reason)
                self._count("AUTOPILOT_ACTIONS",
                            labels=(a.kind, "dryrun"))
                return self._result(a, "dryrun")
            # (the autopilot.execute chaos site fires inside the
            # injected node_post transport, so every dispatch below is
            # individually breakable)
            target, last = "", None
            policy = RetryPolicy(max_attempts=2, base_delay=0.2,
                                 total_timeout=900.0,
                                 sleep=self._sleep,
                                 name=f"autopilot.{a.kind}")
            done = False
            async for _ in policy.attempts():
                try:
                    target = await self._dispatch(a)
                    done = True
                    break
                except (aiohttp_errors() + (OSError, ActionError,
                                            asyncio.TimeoutError)) as e:
                    last = e
            if not done:
                raise last if last is not None \
                    else ActionError("retries exhausted")
            secs = time.monotonic() - t0
            events.record("autopilot_action", kind=a.kind, vid=a.vid,
                          target=target, reason=a.reason,
                          seconds=round(secs, 3))
            self._count("AUTOPILOT_ACTIONS", labels=(a.kind, "ok"))
            self._count("AUTOPILOT_REPAIR_BYTES", a.bytes_est)
            return self._result(a, "ok", target=target, seconds=secs)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — one failed repair must
            # not end the cycle; the failure is journaled and the next
            # cycle re-plans from fresh observation
            secs = time.monotonic() - t0
            glog.warning("autopilot %s vid=%d: %s: %s", a.kind, a.vid,
                         type(e).__name__, e)
            events.record("autopilot_action", kind=a.kind, vid=a.vid,
                          target=a.target, error=str(e)[:160],
                          reason=a.reason)
            self._count("AUTOPILOT_ACTIONS", labels=(a.kind, "error"))
            return self._result(a, "error", error=str(e)[:300],
                                seconds=secs)
        finally:
            self.in_flight.pop(a.key(), None)

    # ---- per-kind dispatch --------------------------------------------

    async def _dispatch(self, a: Action) -> str:
        if a.kind == KIND_REBUILD:
            return await self._rebuild(a)
        if a.kind == KIND_REPLICATE:
            return await self._replicate(a)
        if a.kind == KIND_VACUUM:
            return await self._vacuum(a)
        if a.kind == KIND_TIER:
            return await self._tier(a)
        raise ActionError(f"unknown action kind {a.kind!r}")

    async def _rebuild(self, a: Action) -> str:
        """Rebuild-to-target: one POST per attempt; ranked fallback
        targets absorb a refusing node (dead, wrong -workers
        partition, no space)."""
        sources = ",".join(f"{sid}:{url}" for sid, url in a.sources)
        last: Exception | None = None
        for target in (a.targets or (a.target,)):
            try:
                await self.node_post(
                    target, "/admin/ec/rebuild_shard",
                    {"volume": str(a.vid), "collection": a.collection,
                     "shards": ",".join(map(str, a.shards)),
                     "sources": sources}, timeout_s=600.0)
                return target
            except (aiohttp_errors() + (OSError, ActionError,
                                        asyncio.TimeoutError)) as e:
                last = e
        raise last if last is not None else ActionError("no target")

    async def _replicate(self, a: Action) -> str:
        last: Exception | None = None
        src = a.holders[0]
        for target in (a.targets or (a.target,)):
            try:
                await self.node_post(
                    target, "/admin/volume/copy",
                    {"volume": str(a.vid), "collection": a.collection,
                     "source": src}, timeout_s=600.0)
                return target
            except (aiohttp_errors() + (OSError, ActionError,
                                        asyncio.TimeoutError)) as e:
                last = e
        raise last if last is not None else ActionError("no target")

    async def _vacuum(self, a: Action) -> str:
        """compact -> commit on every holder, cleanup on failure — the
        shell volume.vacuum workflow, demand-driven. Each phase awaits
        EVERY holder (return_exceptions) before deciding: a bare
        gather would raise on the first failure while sibling
        compacts are still rewriting, and firing cleanup concurrently
        with an in-flight compact would delete its .cpd/.cpx out from
        under it."""
        vid = {"volume": str(a.vid)}

        async def phase(path: str, timeout_s: float) -> None:
            done = await asyncio.gather(*(
                self.node_post(u, path, vid, timeout_s=timeout_s)
                for u in a.holders), return_exceptions=True)
            for r in done:
                if isinstance(r, BaseException):
                    raise r
        try:
            await phase("/admin/vacuum/compact", 600.0)
            await phase("/admin/vacuum/commit", 600.0)
        except Exception:
            await asyncio.gather(*(
                self.node_post(u, "/admin/vacuum/cleanup", vid,
                               timeout_s=60.0) for u in a.holders),
                return_exceptions=True)
            raise
        return ",".join(a.holders)

    async def _tier(self, a: Action) -> str:
        for u in a.holders:
            await self.node_post(
                u, "/admin/tier/upload",
                {"volume": str(a.vid), "backend": a.target},
                timeout_s=600.0)
        return ",".join(a.holders)


def aiohttp_errors() -> tuple:
    """aiohttp's error tuple, import-deferred so pure-planner tests
    never pay for (or require) the HTTP stack."""
    import aiohttp
    return (aiohttp.ClientError,)
