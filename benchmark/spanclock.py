"""The program's spans on the device trace's clock.

A span's `start_ms` is the host's wall clock (`time.time()`); the device
trace's times are microseconds on torch.profiler's own clock, whose base
the trace reader drops. One offset maps the first onto the second:

    trace_us = start_ms * 1000 + delta_us

The anchors that fix it are the program's `ec.h2d` and `ec.d2h` spans:
each encloses the one `cudaMemcpyAsync` it enqueues, and the trace keeps
that runtime call from every thread (its host operators only from the
thread that started the profiler, so the program's Python is not in it).
A coarse offset is the mode of (copy start - span start) over a sample
of anchors: the mode, not the mean, since a thread that loses the GIL
between entering a span and making its call gives a long tail. The
offset kept is the one at which the most anchors enclose a copy's start,
at the top of that range: the least lag from a span's start to its call
is taken as 0.

An alignment stands only where at least 99% of the window's `ec.h2d`
spans enclose a copy's start once mapped (`matched`). A run with no
device trace, no runtime calls or fewer matches has none, and every
reader of this module then reports nothing.

With the offset, each GET's thread is followed through its spans: at
each instant the innermost open span under its root (`bench.get`) names
what the thread was doing. The time it spent so while the card was idle
(the complement of the trace's busy intervals) is summed by that name.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import numpy as np

ANCHORS = ("h2d", "d2h")        # ec.<op> spans that enclose one copy call
COPY_CALL = "cudaMemcpyAsync"
MIN_MATCHED = 0.99
COARSE_BIN_US = 50.0
COARSE_SAMPLE = 256             # anchors the coarse mode is taken over
SEARCH_US = 10e6                # how far the first guess may be off
REFINE_US = 1e3                 # copies around the coarse offset
ROUND_US = 1.0                  # spans keep start and duration to 1 us


@dataclass
class Alignment:
    delta_us: float
    matched: float          # share of the window's ec.h2d spans matched
    anchors: int            # the window's ec.h2d spans
    residual_us: tuple      # p25, p50, p75, p99 of copy start - span start
    gets: dict              # trace id -> spans of each GET in the window
    _idle: dict | None = None

    def idle_split(self, trace) -> dict[str, float]:
        """Microseconds of GET-thread time while the card was idle, by
        the innermost span (`tier.op`; `ec.recover.card` and
        `ec.recover.host` apart)."""
        if self._idle is None:
            self._idle = _idle_split(self, trace)
        return self._idle


def name(s: dict) -> str:
    if s["tier"] == "ec" and s["op"] == "recover":
        return "ec.recover." + (s.get("attrs") or {}).get("path", "host")
    return f"{s['tier']}.{s['op']}"


def window_gets(spans: list, wall: tuple) -> dict[str, list]:
    """The spans of every GET root that lies inside the traced window
    (`clock.trace_wall`), by trace id."""
    lo, hi = wall
    gets = {s["trace"]: [] for s in spans
            if s["tier"] == "bench" and s["op"] == "get"
            and lo <= s["start_ms"] / 1e3
            and (s["start_ms"] + s["dur_ms"]) / 1e3 <= hi}
    for s in spans:
        if s["trace"] in gets:
            gets[s["trace"]].append(s)
    return gets


def align(spans: list | None, trace, wall: tuple) -> Alignment | None:
    """The offset of `spans` onto `trace`'s clock, or None."""
    if spans is None or trace is None:
        return None
    copies = np.sort(np.array([o.start_us for o in trace.host_ops
                               if o.cat == "cuda_runtime"
                               and COPY_CALL in o.name], dtype=np.float64))
    lo, hi = wall[0] * 1e3, wall[1] * 1e3
    anchors = sorted((s["start_ms"] * 1e3, s["dur_ms"] * 1e3,
                      s["op"] == "h2d") for s in spans
                     if s["tier"] == "ec" and s["op"] in ANCHORS
                     and lo <= s["start_ms"] <= hi)
    if not copies.size or not any(h for _, _, h in anchors):
        return None
    a = np.array(anchors, dtype=np.float64)
    s0, s1, h2d = a[:, 0], a[:, 0] + a[:, 1], a[:, 2] > 0
    delta = _refine(s0, s1, copies, _coarse(s0, copies))
    i = np.searchsorted(copies, s0 + delta - ROUND_US, "left")
    hit = i < copies.size
    hit[hit] &= copies[i[hit]] <= s1[hit] + delta + ROUND_US
    matched = float(hit[h2d].mean())
    if matched < MIN_MATCHED:
        return None
    res = copies[i[hit & h2d]] - (s0[hit & h2d] + delta)
    q = tuple(float(x) for x in np.percentile(res, [25, 50, 75, 99]))
    return Alignment(delta, matched, int(h2d.sum()), q,
                     window_gets(spans, wall))


def _coarse(s0: np.ndarray, copies: np.ndarray) -> float:
    """The mode of copy start - span start, in COARSE_BIN_US bins, over
    a sample of anchors, within SEARCH_US of the first copy against the
    first anchor."""
    guess = copies[0] - s0[0]
    pick = s0[np.unique(np.linspace(0, s0.size - 1,
                                    min(s0.size, COARSE_SAMPLE)).astype(int))]
    lo = np.searchsorted(copies, pick + guess - SEARCH_US, "left")
    hi = np.searchsorted(copies, pick + guess + SEARCH_US, "right")
    diffs = np.concatenate([copies[i:j] - s for s, i, j in zip(pick, lo, hi)])
    bins = np.floor((diffs - guess) / COARSE_BIN_US)
    vals, counts = np.unique(bins, return_counts=True)
    return guess + (vals[np.argmax(counts)] + 0.5) * COARSE_BIN_US


def _refine(s0: np.ndarray, s1: np.ndarray, copies: np.ndarray,
            coarse: float) -> float:
    """The top of the first range of offsets at which the most anchors
    enclose a copy's start. An anchor [s0, s1] encloses a copy at r under
    offsets [r - s1, r - s0]; each anchor counts once however many copies
    it encloses."""
    lo = np.searchsorted(copies, s0 + coarse - REFINE_US, "left")
    hi = np.searchsorted(copies, s1 + coarse + REFINE_US, "right")
    edges = []
    for a0, a1, i, j in zip(s0, s1, lo, hi):
        cur = None
        for r in copies[i:j]:
            if cur is not None and r - a1 <= cur[1]:
                cur[1] = r - a0
                continue
            if cur is not None:
                edges += [(cur[0], 0), (cur[1], 1)]
            cur = [r - a1, r - a0]
        if cur is not None:
            edges += [(cur[0], 0), (cur[1], 1)]
    # at one offset an opening sorts before a closing: ranges are closed
    edges.sort()
    best, count, top, rising = 0, 0, coarse, False
    for x, closing in edges:
        if not closing:
            count += 1
            if count > best:
                best, rising = count, True
        else:
            if rising:
                top, rising = x, False
            count -= 1
    return float(top)


def _pieces(spans: list) -> list:
    """(name, start_ms, end_ms) of one GET's thread: at each instant the
    innermost open span. A child's ends are clipped to its parent's,
    which rounding to the microsecond can cross."""
    by_id = {s["span"]: s for s in spans}

    def depth(s: dict) -> int:
        d = 0
        while s["parent"] in by_id and d < len(by_id):
            s, d = by_id[s["parent"]], d + 1
        return d

    out: list = []
    stack: list = []            # (name, end_ms)
    t = None
    for s in sorted(spans, key=lambda s: (s["start_ms"], depth(s))):
        start = s["start_ms"] if t is None else max(s["start_ms"], t)
        while stack and stack[-1][1] <= start:
            nm, end = stack.pop()
            if end > t:
                out.append((nm, t, end))
                t = end
        if stack and start > t:
            out.append((stack[-1][0], t, start))
        t = start
        end = s["start_ms"] + s["dur_ms"]
        stack.append((name(s), min(end, stack[-1][1]) if stack else end))
    while stack:
        nm, end = stack.pop()
        if end > t:
            out.append((nm, t, end))
            t = end
    return out


def _idle_split(a: Alignment, trace) -> dict[str, float]:
    busy = trace.busy_intervals()
    b0 = np.array([b[0] for b in busy], dtype=np.float64)
    blen = np.array([b[1] - b[0] for b in busy], dtype=np.float64)
    cum = np.concatenate([[0.0], np.cumsum(blen)])

    def busy_before(t: np.ndarray) -> np.ndarray:
        i = np.searchsorted(b0, t, "right") - 1
        j = np.maximum(i, 0)
        inside = np.minimum(t - b0[j], blen[j]) if b0.size else 0.0
        return np.where(i >= 0, cum[j] + inside, 0.0)

    names, starts, ends = [], [], []
    for spans in a.gets.values():
        for nm, t0, t1 in _pieces(spans):
            names.append(nm)
            starts.append(t0 * 1e3 + a.delta_us)
            ends.append(t1 * 1e3 + a.delta_us)
    if not names:
        return {}
    t0, t1 = np.array(starts), np.array(ends)
    idle = (t1 - t0) - (busy_before(t1) - busy_before(t0))
    out: dict[str, float] = {}
    for nm, us in zip(names, idle.tolist()):
        out[nm] = out.get(nm, 0.0) + us
    return out


_last: list = []        # [(weakref to the run, its alignment)]


def of(run) -> Alignment | None:
    """The alignment of a run's spans, kept for the run's other readers."""
    if _last and _last[0][0]() is run:
        return _last[0][1]
    a = align(run.spans, run.trace, run.clock.trace_wall)
    _last[:] = [(weakref.ref(run), a)]
    return a


def per_get(run, names: tuple) -> float | None:
    """Milliseconds of the named spans per GET of the window."""
    a = of(run)
    if a is None:
        return None
    total = sum(s["dur_ms"] for spans in a.gets.values() for s in spans
                if name(s) in names)
    return total / len(a.gets) if a.gets else 0.0


def per_card_recover(run, names: tuple) -> float | None:
    """Milliseconds of the named children of card recovers (`ec.recover`
    with `path` "card") per card recover of the window."""
    a = of(run)
    if a is None:
        return None
    total, n = 0.0, 0
    for spans in a.gets.values():
        card = {s["span"] for s in spans if name(s) == "ec.recover.card"}
        n += len(card)
        total += sum(s["dur_ms"] for s in spans
                     if s["parent"] in card and name(s) in names)
    return total / n if n else 0.0


def host_recover_per_get(run) -> float | None:
    """Milliseconds of host recovers, less their survivors' gather, per
    GET of the window."""
    a = of(run)
    if a is None:
        return None
    total = 0.0
    for spans in a.gets.values():
        host = {s["span"]: s["dur_ms"] for s in spans
                if name(s) == "ec.recover.host"}
        total += sum(host.values()) - sum(
            s["dur_ms"] for s in spans
            if s["parent"] in host and name(s) == "ec.gather")
    return total / len(a.gets) if a.gets else 0.0


def idle_share(run, names: tuple) -> float | None:
    """The share, in percent, of GET-thread time during the card's idle
    time whose innermost span is one of `names`."""
    a = of(run)
    if a is None:
        return None
    split = a.idle_split(run.trace)
    total = sum(split.values())
    if total <= 0:
        return 0.0
    return 100.0 * sum(split.get(n, 0.0) for n in names) / total
