"""fetch_ms_per_get.<op>: milliseconds of `ec.fetch` spans (one a peer
the GET's server asked for shard intervals, from the request to its
parsed answer) per GET of the traced window; nothing where the window's
GETs hold no such span, as under a program that opens none."""

from benchmark import spanclock


def read(run):
    if run.spans is None:
        return None
    gets = spanclock.window_gets(run.spans, run.clock.trace_wall)
    fetch = [s["dur_ms"] for spans in gets.values() for s in spans
             if spanclock.name(s) == "ec.fetch"]
    if not fetch:
        return None
    return sum(fetch) / len(gets)
