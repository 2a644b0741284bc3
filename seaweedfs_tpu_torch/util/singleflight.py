"""Call collapsing ("singleflight") for duplicate in-flight work.

Reference idiom: golang.org/x/sync/singleflight as used by the
reference's wdclient lookups and chunk fetches — when N callers ask for
the same key concurrently, ONE underlying call runs and every caller
shares its result (or its exception).

Asyncio-native: the collapse window is the leader's await, so this is
for coroutine call sites (client lookups, chunk fetches). Work that
runs in executor threads stays un-collapsed — the volume needle cache
doesn't need it because a disk pread is cheaper than cross-thread
coordination at that granularity.

A copy of seaweedfs_tpu/util/singleflight.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio

from .aio import detach


class SingleFlight:
    """Collapse concurrent ``do(key, fn)`` calls into one ``fn()``.

    The first caller for a key becomes the leader and runs ``fn``;
    followers await the leader's future. Exceptions propagate to every
    caller of that round. The key is forgotten the moment the round
    settles, so a later call retries fresh (errors are never cached
    here — negative caching is a policy the caller layers on top).
    """

    def __init__(self):
        self._inflight: dict[object, asyncio.Future] = {}
        # rounds that had at least one follower / total underlying calls
        self.collapsed = 0
        self.calls = 0

    def pending(self, key) -> bool:
        return key in self._inflight

    async def do(self, key, fn):
        task = self._inflight.get(key)
        if task is None:
            self.calls += 1
            # fn runs as a DETACHED task: cancelling any caller —
            # including the one that started the round — must not
            # cancel the shared work out from under the others (a
            # disconnecting client would otherwise abort every
            # concurrent reader of the same chunk); aio.detach also
            # retains the handle and consumes the terminal exception
            # so nothing logs "never retrieved"
            task = detach(self._run(key, fn))
            self._inflight[key] = task
        else:
            self.collapsed += 1
        # shield: a cancelled caller stops waiting; the task runs on
        return await asyncio.shield(task)

    async def _run(self, key, fn):
        try:
            return await fn()
        finally:
            self._inflight.pop(key, None)
