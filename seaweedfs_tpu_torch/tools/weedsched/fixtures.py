"""Seeded known-bug fixtures: the two historical concurrency bugs,
re-introduced in mini-classes the explorer MUST detect.

These are the dynamic twins of the weedlint phase-3 fixture trees —
the same bug shapes, alive. Each carries a ``weedlint: ignore``
suppression naming itself a seeded fixture: that keeps the enforced
tree's baseline empty while PROVING (via the unused-suppression rule)
that the static side still flags the shape — if a rule regression
stopped firing here, the suppression would go stale and fail the
lint gate.

* ``pending-leak`` — the FrameChannel ``_request`` bug fixed in this
  tree: a pending-table registration whose pop lives on the straight
  path only, so a caller cancelled between registration and response
  leaks the entry forever (the reader loop then counts a phantom
  in-flight request against its timeout accounting).
* ``gen-fence`` — the TieredChunkCache shape before fill tokens: a
  read-check / await / write with no re-validation, so a fill that
  raced an overwrite installs stale bytes under the new generation.

Both must fail under exploration with a minimized schedule; a green
run here means the explorer lost its teeth (tests assert detection).
"""

from __future__ import annotations

import asyncio

from .scenarios import Run, Scenario


class LeakyPendingTable:
    """The pre-fix ``FrameChannel._request`` shape: pop only on the
    straight-line path, never in a ``finally``."""

    def __init__(self):
        self.pending: dict[int, asyncio.Future] = {}

    async def request(self, rid: int) -> None:
        fut = asyncio.get_running_loop().create_future()
        self.pending[rid] = fut  # weedlint: ignore[cancel-leak] seeded known-bug fixture: weedsched must detect this leak dynamically; the suppression going stale means the static rule lost it too
        await asyncio.sleep(0)          # the wire round trip
        if not fut.done():
            fut.set_result(None)        # the peer answers
        await fut
        self.pending.pop(rid, None)     # never reached when cancelled


def _pending_leak() -> Run:
    tbl = LeakyPendingTable()

    async def req(i: int) -> None:
        await tbl.request(i)

    def check() -> list:
        if tbl.pending:
            return [f"leaked pending entries: {sorted(tbl.pending)}"]
        return []

    return Run(tasks=[("req-1", req(1)), ("req-2", req(2))],
               check=check)


class UnfencedCache:
    """The pre-token cache-fill shape: the presence check is not
    re-validated after the fetch await, so a racing invalidation is
    overwritten by stale bytes."""

    def __init__(self, source: dict):
        self.data: dict[str, bytes] = {}
        self.source = source

    async def fill(self, key: str) -> None:
        if key not in self.data:
            stale = self.source[key]
            await asyncio.sleep(0)      # the network fetch
            self.data[key] = stale  # weedlint: ignore[await-atomicity] seeded known-bug fixture: weedsched must detect the stale fill dynamically; the suppression going stale means the static rule lost it too


def _gen_fence() -> Run:
    source = {"k": b"v1"}
    cache = UnfencedCache(source)

    async def filler() -> None:
        for _ in range(2):
            await cache.fill("k")
            await asyncio.sleep(0)

    async def overwrite() -> None:
        await asyncio.sleep(0)
        # new generation lands and invalidates, atomically
        source["k"] = b"v2"
        cache.data.pop("k", None)

    def check() -> list:
        got = cache.data.get("k")
        if got is not None and got != source["k"]:
            return [f"stale bytes {got!r} cached over newest "
                    f"{source['k']!r}"]
        return []

    return Run(tasks=[("fill", filler()), ("fill-2", filler()),
                      ("overwrite", overwrite())],
               check=check)


FIXTURES: dict[str, Scenario] = {
    "pending-leak": Scenario(
        "pending-leak", _pending_leak, victims=("req-1", "req-2"),
        kind="fixture", expect_violation=True,
        description="pending-table registration with no finally: a "
                    "cancelled requester must leak the entry"),
    "gen-fence": Scenario(
        "gen-fence", _gen_fence, victims=("fill", "fill-2"),
        kind="fixture", expect_violation=True,
        description="un-fenced read-check/await/write fill: some "
                    "interleaving must install stale bytes"),
}
