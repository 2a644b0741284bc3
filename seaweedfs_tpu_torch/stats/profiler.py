"""Continuous sampling profiler: low-overhead, trace-tier-attributed.

``-cpuprofile`` answers "where did this PROCESS spend its life", but
only at exit and only with cProfile's per-call overhead. This module
is the always-on complement: a daemon thread samples every thread's
Python stack via ``sys._current_frames()`` at ``-profile.hz`` (default
0 = off), folds each stack into a bounded per-process aggregate, and
prefixes every folded stack with the TIER of the trace span active on
that thread (util/tracing.py maintains the per-thread tier map while
the profiler is armed) — so "30% of samples under ``s3;…gather_chunks``
while the fleet pages" reads straight off the flamegraph.

Design constraints:

- deterministic accounting: the sampler schedules ticks on absolute
  deadlines (``next += period``), so ``samples ≈ hz × uptime`` within
  scheduler jitter — the overhead gate in tests asserts this, and
  ``SeaweedFS_profile_samples_total`` exports the same count;
- bounded memory: at most :data:`MAX_FOLDED` distinct folded stacks
  per collector; overflow folds into the ``(other)`` bucket;
- the sampler thread never takes the GIL for long: one
  ``sys._current_frames()`` call plus pure-Python frame walking, no
  allocation proportional to anything but stack depth;
- served at ``/debug/profile`` (``/__debug__/profile`` on the
  path-shadowing gateways): the always-on aggregate by default,
  ``?seconds=N`` records a fresh on-demand window (spinning a
  temporary sampler at :data:`DEFAULT_WINDOW_HZ` when ``-profile.hz``
  is 0), ``?format=folded`` renders flamegraph-ready folded lines.
  Under ``-workers`` the volume server merges siblings by summing
  folded counts — the same whole-host discipline as every surface.

A copy of seaweedfs_tpu/stats/profiler.py in the PyTorch port.
"""

from __future__ import annotations

import sys
import threading
import time

DEFAULT_WINDOW_HZ = 99.0     # on-demand window rate when -profile.hz 0
MAX_HZ = 1000.0
MAX_WINDOW_S = 60.0
MAX_FOLDED = 4096            # distinct folded stacks per collector
MAX_STACK_DEPTH = 64
_OTHER = "(other)"

_lock = threading.Lock()
_hz = 0.0
_agg = {"folded": {}, "samples": 0}
_sinks: list[dict] = []      # transient ?seconds=N window collectors
_thread: "threading.Thread | None" = None
_stop = threading.Event()

# lazily-bound prometheus counter (same shape as tracing._observe)
_counter: object = None


def init(hz: float = 0.0) -> None:
    """Wire from the CLI flag: -profile.hz (0 disables the always-on
    sampler; /debug/profile?seconds=N still works on demand)."""
    global _hz
    _hz = max(0.0, min(float(hz), MAX_HZ))


def enabled() -> bool:
    return _hz > 0


def running() -> bool:
    return _thread is not None and _thread.is_alive()


def reset() -> None:
    """Drop the aggregate (tests)."""
    with _lock:
        _agg["folded"] = {}
        _agg["samples"] = 0


def start() -> "threading.Thread | None":
    """Start the always-on sampler thread (idempotent; no-op at
    -profile.hz 0). Called per process, so every -workers sibling
    samples itself."""
    global _thread
    if _hz <= 0 or running():
        return _thread
    from ..util import tracing
    tracing.track_thread_tiers(True)
    _stop.clear()
    _thread = threading.Thread(
        target=_run, args=(_hz, _stop, None),
        name="swtpu-profiler", daemon=True)
    _thread.start()
    return _thread


def stop() -> None:
    """Stop the always-on sampler (tests / shutdown)."""
    global _thread
    _stop.set()
    t = _thread
    if t is not None and t.is_alive():
        t.join(timeout=2.0)
    _thread = None
    from ..util import tracing
    tracing.track_thread_tiers(False)


# ---------------------------------------------------------------------------
# the sampler


def _run(hz: float, stop: threading.Event,
         sinks: "list[dict] | None") -> None:
    """Sampler loop on ABSOLUTE deadlines: an oversleeping tick is
    followed by an immediate one, so the total sample count tracks
    hz × elapsed (the deterministic-accounting contract) instead of
    accumulating per-tick drift."""
    period = 1.0 / hz
    next_t = time.perf_counter() + period
    while not stop.wait(max(0.0, next_t - time.perf_counter())):
        now = time.perf_counter()
        if now - next_t > 1.0:
            # a long stall (suspend, GC storm): re-anchor instead of
            # bursting hundreds of catch-up samples in one slice
            next_t = now
        next_t += period
        _sample_once(sinks)


def _sample_once(sinks: "list[dict] | None") -> None:
    from ..util import tracing
    me = threading.get_ident()
    frames = sys._current_frames()
    keys: list[str] = []
    for tid, frame in frames.items():
        if tid == me:
            continue
        stack: list[str] = []
        f = frame
        while f is not None and len(stack) < MAX_STACK_DEPTH:
            co = f.f_code
            stack.append(
                f"{co.co_filename.rsplit('/', 1)[-1]}:{co.co_name}")
            f = f.f_back
        if not stack:
            continue
        stack.reverse()
        tier = tracing.thread_tier(tid) or "-"
        keys.append(tier + ";" + ";".join(stack))
    del frames
    with _lock:
        targets = [_agg] + _sinks if sinks is None else sinks
        for sink in targets:
            sink["samples"] += 1
            folded = sink["folded"]
            for key in keys:
                if key in folded:
                    folded[key] += 1
                elif len(folded) < MAX_FOLDED:
                    folded[key] = 1
                else:
                    folded[_OTHER] = folded.get(_OTHER, 0) + 1
    _count_sample()


def _count_sample() -> None:
    global _counter
    if _counter is None:
        try:
            from . import metrics
            _counter = (metrics.PROFILE_SAMPLES
                        if metrics.HAVE_PROMETHEUS else False)
        except ImportError:
            _counter = False
    if _counter:
        _counter.inc()


# ---------------------------------------------------------------------------
# payloads


def profile_dict() -> dict:
    """The always-on aggregate: the /debug/profile body without
    ?seconds=."""
    with _lock:
        folded = dict(_agg["folded"])
        samples = _agg["samples"]
    return {"hz": _hz, "running": running(), "window_s": 0.0,
            "samples": samples, "folded": folded}


async def profile_window(seconds: float,
                         hz: "float | None" = None) -> dict:
    """Record a fresh folded window of `seconds`: piggybacks on the
    always-on sampler when it runs (a registered sink sees exactly the
    window's ticks), otherwise spins a temporary sampler at `hz`
    (default :data:`DEFAULT_WINDOW_HZ`)."""
    import asyncio
    seconds = max(0.05, min(float(seconds), MAX_WINDOW_S))
    sink = {"folded": {}, "samples": 0}
    if running():
        with _lock:
            _sinks.append(sink)
        try:
            await asyncio.sleep(seconds)
        finally:
            with _lock:
                _sinks.remove(sink)
        rate = _hz
    else:
        rate = max(1.0, min(float(hz or DEFAULT_WINDOW_HZ), MAX_HZ))
        from ..util import tracing
        tracing.track_thread_tiers(True)
        stop = threading.Event()
        t = threading.Thread(target=_run, args=(rate, stop, [sink]),
                             name="swtpu-profile-window", daemon=True)
        t.start()
        try:
            await asyncio.sleep(seconds)
        finally:
            stop.set()
            if not running():
                tracing.track_thread_tiers(False)
        t.join(timeout=2.0)
    with _lock:
        folded = dict(sink["folded"])
        samples = sink["samples"]
    return {"hz": rate, "running": running(),
            "window_s": round(seconds, 3), "samples": samples,
            "folded": folded}


def merge_payloads(payloads: "list[dict]") -> dict:
    """Fold several workers' /debug/profile bodies into one whole-host
    view: folded counts and sample counts SUM per stack (each worker
    sampled only itself), hz/window report the max."""
    folded: dict[str, int] = {}
    samples = 0
    hz = 0.0
    window = 0.0
    run = False
    for p in payloads:
        samples += int(p.get("samples", 0) or 0)
        hz = max(hz, float(p.get("hz", 0) or 0))
        window = max(window, float(p.get("window_s", 0) or 0))
        run = run or bool(p.get("running"))
        for k, v in (p.get("folded") or {}).items():
            folded[k] = folded.get(k, 0) + int(v)
    return {"hz": hz, "running": run, "window_s": window,
            "samples": samples, "folded": folded}


def folded_text(payload: dict) -> str:
    """Flamegraph-ready folded lines ("stack count"), deterministic
    order (count desc, then stack) — pipe straight into flamegraph.pl
    or speedscope."""
    rows = sorted((payload.get("folded") or {}).items(),
                  key=lambda kv: (-kv[1], kv[0]))
    return "\n".join(f"{k} {v}" for k, v in rows) + ("\n" if rows else "")


async def profile_query(query) -> dict:
    """The one /debug/profile parser shared by every server handler:
    ?seconds=N records an on-demand window (clamped to 60s), otherwise
    the always-on aggregate (raises ValueError on malformed values)."""
    seconds = float(query.get("seconds", 0) or 0)
    if seconds > 0:
        hz = query.get("hz")
        return await profile_window(seconds,
                                    hz=float(hz) if hz else None)
    return profile_dict()


def debug_handler():
    """One aiohttp /debug/profile handler — registered by every
    non-worker-aggregating server (master, filer, S3, WebDAV); the
    volume server has its own -workers-merging twin."""
    from aiohttp import web

    async def h_profile(req):
        try:
            payload = await profile_query(req.query)
        except ValueError:
            return web.json_response({"error": "bad seconds/hz"},
                                     status=400)
        if req.query.get("format") == "folded":
            return web.Response(text=folded_text(payload),
                                content_type="text/plain")
        return web.json_response(payload)

    return h_profile
