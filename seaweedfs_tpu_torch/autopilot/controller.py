"""The autopilot controller: the leader-side observe -> plan -> execute
loop, plus the ``/debug/autopilot`` status surface.

Lifecycle mirrors the scrubber's: the object always exists on the
master (so ``POST /debug/autopilot?run=1`` can force a deterministic
cycle even with the loop off — how tests and the heal soak drive it),
the long-lived loop only runs when ``-autopilot.interval`` > 0, and
the first cycle fires one interval after boot so a restarting cluster
is not greeted by a repair stampede racing its own recovery.

Leader discipline: a follower's loop idles (state ``follower``); a
leader deposed mid-cycle halts its executor — the new leader's
autopilot owns the cluster from its own fresh observation.

Cross-cycle damping lives here, NOT in the planner (which must stay
pure): actions executed recently are cooled down (successes for
``cooldown_s`` — defaulted ABOVE the default scrub interval, because a
repaired-in-place rotten shard keeps appearing in every holder's
stale ``last_cycle`` report until the NEXT scrub pass replaces it, and
re-planning it would delete and regenerate an already-clean shard
every cycle; failures for a shorter window so the next cycle retries
without hot-looping), and every filtered action is journaled as an
``autopilot_defer`` with the reason.

A copy of seaweedfs_tpu/autopilot/controller.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import collections
import time

import aiohttp

from ..security import tls
from ..util import events, failpoints, glog
from .execute import ActionError, Executor
from .observe import Observer
from .plan import PlannerConfig, plan


class Autopilot:
    """One per master process; active only while that master leads."""

    MAX_HISTORY = 16                # kept cycle reports (/debug surface)
    MAX_DEFER_EVENTS = 20           # journal rows per cycle (bounded)

    def __init__(self, master, *,
                 interval_s: float = 0.0,
                 mbps: float = 16.0,
                 dryrun: bool = False,
                 concurrency: int = 2,
                 tier_backend: str = "",
                 garbage_threshold: float = 0.3,
                 cooldown_s: float = 600.0,
                 failure_cooldown_s: float = 10.0,
                 paging_cache_s: float = 5.0):
        self.master = master
        self.interval_s = interval_s
        self.mbps = mbps
        self.dryrun = dryrun
        self.cfg = PlannerConfig(garbage_threshold=garbage_threshold,
                                 tier_backend=tier_backend)
        self.cooldown_s = cooldown_s
        self.failure_cooldown_s = failure_cooldown_s
        self.paging_cache_s = paging_cache_s
        self.observer = Observer(master)
        self.executor = Executor(self._node_post, mbps=mbps,
                                 concurrency=concurrency,
                                 dryrun=dryrun,
                                 is_leader=lambda: master.is_leader,
                                 paging=self._paging)
        self.state = "idle"
        self.cycles = 0
        self.actions_ok = 0
        self.actions_failed = 0
        self.started_at = time.time()
        self.started_mono = time.monotonic()
        self.last_cycle: dict | None = None
        self.history: collections.deque = collections.deque(
            maxlen=self.MAX_HISTORY)
        self._cooldown: dict[tuple, float] = {}
        self._paging_cached: "tuple[float, bool] | None" = None
        self._cycle_lock = asyncio.Lock()

    # ---- transport + paging hooks for the executor --------------------

    async def _node_post(self, url: str, path: str, params: dict,
                         timeout_s: float = 60.0) -> dict:
        # chaos site: every repair dispatch the executor makes is
        # breakable — an injected fault takes the same retry/fallback
        # path a dead target does
        await failpoints.fail("autopilot.execute")
        async with self.master._http.post(
                tls.url(url, path), params=params,
                timeout=aiohttp.ClientTimeout(
                    total=timeout_s)) as resp:
            try:
                body = await resp.json()
            except (ValueError, aiohttp.ContentTypeError):
                body = {"error": (await resp.text())[:200]}
            if resp.status != 200:
                raise ActionError(f"POST {url}{path}: "
                                  f"{body.get('error', resp.status)}")
            return body

    async def _paging(self) -> bool:
        """Cached fleet-wide page check — consulted before every
        action, so it must not cost a full health fan-out each time."""
        now = time.monotonic()
        if self._paging_cached is not None and \
                now - self._paging_cached[0] < self.paging_cache_s:
            return self._paging_cached[1]
        paging = await self.observer.any_paging()
        self._paging_cached = (now, paging)
        return paging

    # ---- metrics -------------------------------------------------------

    @staticmethod
    def _count(name: str, n: float = 1, labels: tuple = ()) -> None:
        from ..stats import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        c = getattr(metrics, name)
        (c.labels(*labels) if labels else c).inc(n)

    # ---- the long-lived loop ------------------------------------------

    async def run(self) -> None:
        """Background task retained by the master and cancelled on
        stop (the orphan-task discipline). First cycle after ONE
        interval — never at boot."""
        while True:
            await asyncio.sleep(self.interval_s)
            if not self.master.is_leader:
                self.state = "follower"
                continue
            try:
                await self.run_cycle()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — the maintenance
                # plane must outlive any one cycle's failure, visibly
                glog.warning("autopilot cycle failed: %s: %s",
                             type(e).__name__, e)
                self.state = "error"

    async def run_cycle(self) -> dict:
        """One observe -> plan -> execute pass. Serialized: a forced
        POST ?run=1 racing the background loop must not double-repair
        (or double-charge the repair budget). A raising phase leaves
        state at `error`, never stuck mid-phase (a forced cycle has no
        surrounding loop to reset it)."""
        async with self._cycle_lock:
            try:
                return await self._cycle_locked()
            except Exception:
                self.state = "error"
                raise

    async def _cycle_locked(self) -> dict:
        t0 = time.monotonic()
        self.state = "observing"
        snap, errors = await self.observer.snapshot()
        # prime the executor's pause gate from the same evidence
        self._paging_cached = (time.monotonic(), snap.paging)

        self.state = "planning"
        # chaos site: a broken planner = a visibly failed cycle
        await failpoints.fail("autopilot.plan")
        actions, deferrals = plan(snap, self.cfg)

        # cross-cycle damping: recently-acted keys wait out their
        # cooldown (the repair needs a heartbeat/scrub cycle to
        # become observable; re-planning it would double-repair)
        now = time.monotonic()
        self._cooldown = {k: t for k, t in self._cooldown.items()
                          if t > now}
        runnable, cooled = [], []
        for a in actions:
            (cooled if a.key() in self._cooldown
             else runnable).append(a)

        ledger = [a.to_dict() for a in runnable]
        deferred = [d.to_dict() for d in deferrals] + [
            {"vid": a.vid, "kind": a.kind, "reason": "cooldown"}
            for a in cooled]
        # the cheap counter sees EVERY deferral; only the journal
        # rows (one ring entry each) are capped per cycle
        for row in deferred:
            self._count("AUTOPILOT_DEFERRALS",
                        labels=(row["reason"],))
        for row in deferred[:self.MAX_DEFER_EVENTS]:
            events.record("autopilot_defer", **row)

        # deposed between observe and execute: the snapshot this cycle
        # planned from belongs to a leadership that no longer exists —
        # the successor's autopilot owns the cluster from ITS fresh
        # observation. Halt with nothing executed (the executor's own
        # is_leader gate also halts a deposition that lands mid-queue).
        if not self.master.is_leader:
            self.state = "follower"
            report = {
                "wall_ms": round(time.time() * 1000.0, 3),
                "seconds": round(time.monotonic() - t0, 3),
                "dryrun": self.dryrun,
                "halted": "lost leadership",
                "observed": {"nodes": len(snap.nodes),
                             "volumes": len(snap.volumes),
                             "ec_volumes": len(snap.ec_volumes),
                             "corruptions": len(snap.corruptions),
                             "paging": snap.paging,
                             "errors": errors},
                "planned": ledger, "deferred": deferred, "executed": [],
            }
            self.last_cycle = report
            self.history.append(report)
            return report

        self.state = "executing"
        results = await self.executor.execute(runnable)
        # cooldowns expire relative to when execution FINISHED: a
        # long paced cycle must not eat its own damping window and
        # re-enable the double-repair the cooldown prevents
        done = time.monotonic()
        for a, r in zip(runnable, results):
            if r["status"] in ("ok", "dryrun"):
                self.actions_ok += 1
                self._cooldown[a.key()] = done + self.cooldown_s
            elif r["status"] == "error":
                self.actions_failed += 1
                self._cooldown[a.key()] = \
                    done + self.failure_cooldown_s

        self.cycles += 1
        self._count("AUTOPILOT_CYCLES")
        report = {
            "wall_ms": round(time.time() * 1000.0, 3),
            "seconds": round(time.monotonic() - t0, 3),
            "dryrun": self.dryrun,
            "observed": {
                "nodes": len(snap.nodes),
                "volumes": len(snap.volumes),
                "ec_volumes": len(snap.ec_volumes),
                "corruptions": len(snap.corruptions),
                "paging": snap.paging,
                "errors": errors,
            },
            "planned": ledger,
            "deferred": deferred,
            "executed": results,
        }
        self.last_cycle = report
        self.history.append(report)
        self.state = "idle"
        return report

    # ---- /debug/autopilot ---------------------------------------------

    def status(self) -> dict:
        return {
            "enabled": self.interval_s > 0,
            "leader": self.master.is_leader,
            "dryrun": self.dryrun,
            "state": self.state,
            "interval_s": self.interval_s,
            "budget_mbps": self.mbps,
            "cycles": self.cycles,
            "actions_ok": self.actions_ok,
            "actions_failed": self.actions_failed,
            "bytes_paid": self.executor.bytes_paid,
            "paced_sleep_s": round(self.executor.paced_sleep_s, 3),
            "paused_s": round(self.executor.paused_s, 3),
            "in_flight": list(self.executor.in_flight.values()),
            "cooldown": len(self._cooldown),
            "started_wall": round(self.started_at, 3),
            "uptime_s": round(time.monotonic() - self.started_mono, 1),
            "last_cycle": self.last_cycle,
            "history": list(self.history),
        }
