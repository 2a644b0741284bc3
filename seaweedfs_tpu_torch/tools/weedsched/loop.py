"""The controlled event loop: every scheduling decision is a recorded
choice, time is virtual, and a whole run replays from a seed.

``SchedLoop`` implements just enough of the asyncio event-loop surface
for the pure-python task/future/lock machinery to run on it —
``call_soon``/``call_later``/``call_at``/``time``/``create_future``/
``create_task`` plus the handle-cancellation hooks. It is driven
synchronously by the explorer (never ``run_forever``): whenever more
than one callback is runnable, a seeded :class:`Chooser` picks which
runs next and records the pick, so a schedule IS a replayable list of
small integers. Timers advance virtual time only when the ready queue
drains, so a 30s ``wait_for`` deadline costs nothing and a run's
timing is a pure function of its choices.

Deliberately pinned to CPython's pure-python asyncio internals
(``asyncio.tasks._PyTask`` so task step callbacks expose ``__self__``
for ownership, ``Handle._callback``/``Handle._cancelled`` for
dispatch) — the C accelerated Task hides the callback's bound self,
which the explorer needs to attribute steps to tasks and to aim
cancellation injection. Verified against 3.10; guarded imports keep
failures loud, not silent.
"""

from __future__ import annotations

import asyncio
import asyncio.events
import asyncio.tasks
import heapq
import random

# the pure-python Task: its __step/__wakeup callbacks are bound
# methods, so Handle._callback.__self__ identifies the owning task
_PyTask = asyncio.tasks._PyTask


class SchedError(Exception):
    """Explorer-internal failure (livelock backstop, replay misuse) —
    distinct from an invariant violation in the scenario under test."""


class Chooser:
    """Source of scheduling decisions: seeded-random when exploring,
    scripted when replaying a recorded (possibly minimized) schedule.

    ``choices`` accumulates every pick either way, so a fresh random
    run hands the explorer exactly the list it needs to replay."""

    def __init__(self, seed: int = 0, replay: list[int] | None = None):
        self.seed = seed
        self._rng = random.Random(seed)
        self._replay = list(replay) if replay is not None else None
        self.choices: list[int] = []

    def choose(self, n: int) -> int:
        if n <= 0:
            raise SchedError("choose() with an empty ready queue")
        if self._replay is not None:
            pos = len(self.choices)
            # past the recorded tail (minimization trims it): first
            # runnable — the canonical "0" the minimizer drives toward
            i = self._replay[pos] if pos < len(self._replay) else 0
            i = min(max(i, 0), n - 1)
        else:
            i = self._rng.randrange(n)
        self.choices.append(i)
        return i


class SchedLoop:
    """Minimal deterministic event loop; see the module docstring."""

    def __init__(self, chooser: Chooser):
        self._chooser = chooser
        self._ready: list[asyncio.Handle] = []
        self._timers: list[tuple[float, int, asyncio.TimerHandle]] = []
        self._tie = 0               # heap tie-break: insertion order
        self._now = 0.0             # virtual seconds
        self._closed = False
        self._task_seq = 0
        self.tasks: list[asyncio.Task] = []   # every task ever created
        self.cb_errors: list[str] = []        # callback exceptions

    # ---- surface the task/future/lock machinery calls ----

    def get_debug(self) -> bool:
        return False

    def is_running(self) -> bool:
        return True

    def is_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        self._closed = True

    def time(self) -> float:
        return self._now

    def call_soon(self, callback, *args, context=None) -> asyncio.Handle:
        h = asyncio.Handle(callback, args, self, context)
        self._ready.append(h)
        return h

    # same-thread by construction: the explorer never leaves the
    # driving thread, so threadsafe wakeups are plain wakeups
    call_soon_threadsafe = call_soon

    def call_later(self, delay, callback, *args, context=None):
        return self.call_at(self._now + max(0.0, float(delay)),
                            callback, *args, context=context)

    def call_at(self, when, callback, *args, context=None):
        h = asyncio.TimerHandle(float(when), callback, args, self,
                                context)
        self._tie += 1
        heapq.heappush(self._timers, (float(when), self._tie, h))
        h._scheduled = True
        return h

    def _timer_handle_cancelled(self, handle) -> None:
        # lazily dropped when popped; the heap entry is just skipped
        pass

    def create_future(self) -> asyncio.Future:
        return asyncio.Future(loop=self)

    def create_task(self, coro, *, name=None) -> asyncio.Task:
        # explicit deterministic default names: _PyTask's Task-<n>
        # fallback counts GLOBALLY across runs, which would leak run
        # ordering into schedule traces and break byte-identical
        # reports for a given seed
        self._task_seq += 1
        task = _PyTask(coro, loop=self,
                       name=name or f"t{self._task_seq}")
        self.tasks.append(task)
        return task

    def call_exception_handler(self, context: dict) -> None:
        # handle-callback crashes are deterministic and gate the run;
        # future/task __del__ reports arrive at GC time and must not
        # (they are the only nondeterministic entry into this hook)
        if "handle" in context:
            exc = context.get("exception")
            self.cb_errors.append(
                f"{context.get('message', 'callback error')}: "
                f"{type(exc).__name__ if exc else '?'}: {exc}")

    def default_exception_handler(self, context: dict) -> None:
        self.call_exception_handler(context)

    # ---- explorer-side stepping ----

    def runnable(self) -> bool:
        return any(not h._cancelled for h in self._ready) \
            or any(not h._cancelled for _, _, h in self._timers)

    def next_handle(self) -> asyncio.Handle | None:
        """Pick (via the chooser) and remove the next handle to run;
        advances virtual time to the earliest timer when the ready
        queue is empty. None means quiescent."""
        self._ready = [h for h in self._ready if not h._cancelled]
        if not self._ready:
            self._advance_timers()
        if not self._ready:
            return None
        if len(self._ready) == 1:
            # a forced move is not a decision: keeping it out of the
            # schedule makes recorded traces short and minimization
            # meaningful
            return self._ready.pop(0)
        return self._ready.pop(self._chooser.choose(len(self._ready)))

    def _advance_timers(self) -> None:
        while self._timers and not self._ready:
            when, _, h = heapq.heappop(self._timers)
            if h._cancelled:
                continue
            self._now = max(self._now, when)
            self._ready.append(h)
            # everything due at the same virtual instant becomes one
            # scheduling decision, not a fixed heap order
            while self._timers and self._timers[0][0] <= self._now:
                _, _, h2 = heapq.heappop(self._timers)
                if not h2._cancelled:
                    self._ready.append(h2)


class Installed:
    """Context manager: make `loop` the running loop for the calling
    thread so ``get_running_loop()``-based code (futures, locks,
    ensure_future) lands on it, without touching the event loop
    policy."""

    def __init__(self, loop: SchedLoop):
        self.loop = loop
        self._prev = None

    def __enter__(self) -> SchedLoop:
        self._prev = asyncio.events._get_running_loop()
        if self._prev is not None:
            raise SchedError(
                "weedsched cannot run inside a running event loop")
        asyncio.events._set_running_loop(self.loop)
        return self.loop

    def __exit__(self, *exc) -> None:
        asyncio.events._set_running_loop(self._prev)
