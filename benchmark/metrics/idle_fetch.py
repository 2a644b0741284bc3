"""idle_fetch.<op>: the share, in percent, of the GET threads' time
during the card's idle time (on the device trace's clock,
`benchmark/spanclock.py`) in which a thread's innermost span was
`ec.fetch`: waiting on a peer for survivor or intact shard intervals.
The spans the peers open under an `ec.fetch` (their shard_read, joined
to the GET's trace) ran on the peers' threads, not the GET's, and are
left out. Nothing where no GET holds an `ec.fetch` span."""

import dataclasses

from benchmark import spanclock


def _own(spans: list) -> list:
    """A GET's spans less those under its `ec.fetch` spans."""
    by_id = {s["span"]: s for s in spans}
    fetch = {s["span"] for s in spans if spanclock.name(s) == "ec.fetch"}

    def under_fetch(s: dict) -> bool:
        seen = 0
        while s["parent"] in by_id and seen < len(by_id):
            if s["parent"] in fetch:
                return True
            s, seen = by_id[s["parent"]], seen + 1
        return False

    return [s for s in spans if not under_fetch(s)]


def read(run):
    a = spanclock.of(run)
    if a is None or not any(spanclock.name(s) == "ec.fetch"
                            for spans in a.gets.values() for s in spans):
        return None
    own = dataclasses.replace(
        a, gets={t: _own(spans) for t, spans in a.gets.items()},
        _idle=None)
    split = own.idle_split(run.trace)
    total = sum(split.values())
    if total <= 0:
        return 0.0
    return 100.0 * split.get("ec.fetch", 0.0) / total
