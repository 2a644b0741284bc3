"""Drive scenarios under the controlled loop: schedule exploration,
CancelledError injection at every await point, invariant checking,
and coordinate-descent minimization of failing schedules.

A run is identified by (scenario, seed, victim, inject_at): the seed
fixes every scheduling choice, the victim/inject_at pair aims one
``task.cancel()`` at the victim's N-th resumption — exactly the
cancellation a disconnecting client or a timed-out ``wait_for``
delivers at that await point. Violations carry the full choice list;
the minimizer then replays with positions forced to 0 (run the first
runnable) while the violation persists, so the reported schedule is
the shortest divergence from FIFO that still reproduces the bug.

Nothing here reads the wall clock and the report dict is built from
sorted/deterministic collections only, so the JSON a seed produces is
byte-identical across runs — asserted by tests/test_weedsched.py.
"""

from __future__ import annotations

import asyncio
import asyncio.tasks
from dataclasses import dataclass, field

from .loop import Chooser, Installed, SchedError, SchedLoop

# SchedLoop tasks are the pure-python Task, which is NOT an instance
# of the C-accelerated asyncio.Task — ownership checks need both
_TASK_TYPES = (asyncio.tasks._PyTask, asyncio.Task)

# livelock backstop: a run that makes this many steps without settling
# is itself a finding, surfaced loudly instead of hanging CI
MAX_STEPS = 20_000
# post-completion callback drain (done-callbacks, cancelled cleanups)
MAX_DRAIN = 2_000
# per-victim, per-seed injection cap; exceeding it is reported as
# "truncated" in the scenario row — never silently
MAX_INJECTIONS = 48
# replay budget for one minimization (each replay is a full run)
MINIMIZE_BUDGET = 240


@dataclass
class RunResult:
    violations: list[str] = field(default_factory=list)
    schedule: list[int] = field(default_factory=list)
    trace: list[str] = field(default_factory=list)
    resumptions: dict[str, int] = field(default_factory=dict)


def _effective_seed(seed: int, victim: str | None,
                    inject_at: int | None) -> int:
    """Decorrelate injected runs from their baseline: with the raw
    seed, every injection run replays the baseline's choice prefix and
    a whole sweep explores only one schedule per seed. The derivation
    is stable (crc32, not the salted built-in hash) so replays and
    reports stay byte-identical."""
    if victim is None:
        return seed
    import zlib
    return (seed * 1_000_003 + 97 * (inject_at or 0)
            + zlib.crc32(victim.encode())) & 0x7FFFFFFF


def run_once(scn, seed: int, victim: str | None = None,
             inject_at: int | None = None,
             replay: list[int] | None = None,
             max_steps: int = MAX_STEPS) -> RunResult:
    """One complete scenario execution under one schedule."""
    chooser = Chooser(_effective_seed(seed, victim, inject_at),
                      replay=replay)
    loop = SchedLoop(chooser)
    with Installed(loop):
        run = scn.build()
        roots = [loop.create_task(coro, name=name)
                 for name, coro in run.tasks]
        trace, resumptions = _drive(loop, victim, inject_at, max_steps)
        violations: list[str] = []
        undone = sorted(t.get_name() for t in loop.tasks
                        if not t.done())
        if undone:
            violations.append(
                "deadlock: quiescent with unfinished tasks: "
                + ", ".join(undone))
            for t in loop.tasks:
                if not t.done():
                    t.cancel()
            _drain(loop, trace)
        for t in loop.tasks:
            if t.done() and not t.cancelled():
                exc = t.exception()
                if exc is not None:
                    violations.append(
                        f"task {t.get_name()} crashed: "
                        f"{type(exc).__name__}: {exc}")
        violations += loop.cb_errors
        violations += run.check()
        del roots
    return RunResult(violations=violations,
                     schedule=list(chooser.choices),
                     trace=trace, resumptions=resumptions)


def _drive(loop: SchedLoop, victim: str | None, inject_at: int | None,
           max_steps: int) -> tuple[list[str], dict[str, int]]:
    trace: list[str] = []
    resumptions: dict[str, int] = {}
    injected = False
    steps = 0
    while any(not t.done() for t in loop.tasks):
        h = loop.next_handle()
        if h is None:
            break                       # quiescent: checked by caller
        owner = getattr(getattr(h, "_callback", None), "__self__",
                        None)
        if isinstance(owner, _TASK_TYPES):
            name = owner.get_name()
            seen = resumptions.get(name, 0)
            if name == victim and inject_at is not None \
                    and seen == inject_at and not injected:
                # cancel RIGHT BEFORE the victim's chosen resumption:
                # the queued step then raises CancelledError into the
                # coroutine at exactly its current await point
                owner.cancel()
                injected = True
                trace.append(f"cancel!{name}")
            resumptions[name] = seen + 1
        else:
            name = "."                  # plain callback (done hooks,
            #                             timer releases, ...)
        trace.append(name)
        h._run()
        steps += 1
        if steps > max_steps:
            raise SchedError(
                f"livelock: {max_steps} steps without settling "
                f"(trace tail: {trace[-12:]})")
    _drain(loop, trace)
    return trace, resumptions


def _drain(loop: SchedLoop, trace: list[str]) -> None:
    """Run stray callbacks left after every task finished (done
    callbacks, cancellation cleanups) so no handle outlives the run."""
    for _ in range(MAX_DRAIN):
        h = loop.next_handle()
        if h is None:
            return
        trace.append("~")
        h._run()
    raise SchedError("drain did not settle within the step budget")


def minimize(scn, seed: int, victim: str | None, inject_at: int | None,
             schedule: list[int],
             budget: int = MINIMIZE_BUDGET) -> tuple[list[int],
                                                     RunResult]:
    """Coordinate descent toward the FIFO schedule: force one recorded
    choice at a time to 0 and keep the change while the run still
    violates. Returns the minimized choice list and its final run."""
    best = list(schedule)
    replays = 0
    improved = True
    while improved and replays < budget:
        improved = False
        for pos in range(len(best)):
            if best[pos] == 0:
                continue
            cand = best[:pos] + [0] + best[pos + 1:]
            replays += 1
            if run_once(scn, seed, victim=victim, inject_at=inject_at,
                        replay=cand).violations:
                best = cand
                improved = True
            if replays >= budget:
                break
    while best and best[-1] == 0:       # replay pads zeros back
        best.pop()
    final = run_once(scn, seed, victim=victim, inject_at=inject_at,
                     replay=best)
    if not final.violations:            # paranoia: never "minimize" a
        best = list(schedule)           # violation out of existence
        final = run_once(scn, seed, victim=victim,
                         inject_at=inject_at, replay=best)
    return best, final


def explore_scenario(scn, seeds: list[int], inject: bool = True,
                     stop_on_first: bool = False,
                     max_injections: int = MAX_INJECTIONS,
                     minimize_budget: int = MINIMIZE_BUDGET) -> dict:
    """Full sweep of one scenario: a baseline run per seed, then (for
    declared victims) one injected run per await point. Returns a
    deterministic report row."""
    row = {
        "name": scn.name,
        "kind": scn.kind,
        "expect_violation": scn.expect_violation,
        "seeds": list(seeds),
        "runs": 0,
        "injections": 0,
        "truncated": False,
        "violations": [],
    }

    def record(seed, victim, inject_at, res):
        sched, final = minimize(scn, seed, victim, inject_at,
                                res.schedule, budget=minimize_budget)
        row["violations"].append({
            "seed": seed,
            "victim": victim,
            "inject_at": inject_at,
            "errors": final.violations,
            "schedule": sched,
            "schedule_len_original": len(res.schedule),
            "trace": final.trace,
        })

    done = False
    for seed in seeds:
        base = run_once(scn, seed)
        row["runs"] += 1
        if base.violations:
            record(seed, None, None, base)
            if stop_on_first:
                done = True
        if done:
            break
        if not inject:
            continue
        for victim in scn.victims:
            total = base.resumptions.get(victim, 0)
            if total > max_injections:
                row["truncated"] = True
                total = max_injections
            for i in range(total):
                res = run_once(scn, seed, victim=victim, inject_at=i)
                row["runs"] += 1
                row["injections"] += 1
                if res.violations:
                    record(seed, victim, i, res)
                    if stop_on_first:
                        done = True
                        break
            if done:
                break
        if done:
            break
    row["detected"] = bool(row["violations"])
    row["ok"] = row["detected"] == scn.expect_violation
    return row
