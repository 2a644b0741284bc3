"""Sanctioned task-detachment helper.

A task that must SURVIVE its caller's cancellation (a singleflight
leader's shared work, a channel close kicked off from a sync
destructor) has three obligations a bare ``create_task`` silently
drops:

1. the handle must be retained somewhere until the task settles — an
   unreferenced asyncio task may be garbage-collected mid-flight;
2. its terminal exception must be consumed even when every awaiter was
   cancelled first, or asyncio logs "exception was never retrieved"
   at interpreter exit;
3. the detachment must be VISIBLE: readers (and weedlint's
   ``detach-discipline`` pass) treat ``detach(...)`` as the one
   spelling of "this outlives you by design" — a bare
   ``create_task`` next to a "survives cancellation" comment is a
   lint finding, not a convention.

``detach`` is that one spelling. It is NOT for loops whose handle the
owner retains and cancels on shutdown (heartbeats, GC loops) — those
want a plain ``create_task`` stored on the owner so ``stop()`` can
cancel them.

A copy of seaweedfs_tpu/util/aio.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
from typing import Coroutine

# strong refs until each task settles (obligation 1); bounded by the
# number of genuinely in-flight detached tasks
_DETACHED: set[asyncio.Task] = set()


def _settled(task: asyncio.Task) -> None:
    _DETACHED.discard(task)
    if not task.cancelled():
        task.exception()        # consume (obligation 2)


def detach(coro: Coroutine, *, name: str | None = None) -> asyncio.Task:
    """Start ``coro`` as a task that deliberately outlives its caller.

    Cancelling the caller does not cancel the task; the returned
    handle lets interested callers ``await asyncio.shield(task)`` so a
    cancelled awaiter stops waiting while the work runs on.
    """
    task = asyncio.get_running_loop().create_task(coro, name=name)
    _DETACHED.add(task)
    task.add_done_callback(_settled)
    return task


def detached_count() -> int:
    """In-flight detached tasks (test/debug introspection)."""
    return len(_DETACHED)
