"""Saturation probes: is "slow" a saturated resource?

USE-style (utilization/saturation) signals sampled into the metrics
timelines (stats/timeline.py) right before each snapshot, so a latency
regression in a window can be attributed to the resource that
saturated in the SAME window:

- **event-loop lag** — max asyncio scheduling delay since the last
  snapshot (a continuously-running probe task measures the drift of
  short sleeps; anything in the tens of milliseconds means a blocking
  call is squatting the loop);
- **executor queue wait/depth** — how long a just-submitted no-op sat
  in the default ThreadPoolExecutor queue, plus the queue depth when
  introspectable (store preads, EC decodes and vacuum all ride this
  pool: a deep queue is the disk-path saturation signal);
- **open fds** — descriptor count from /proc (volume handles, sockets,
  cache mmaps; a leak shows as a monotonic gauge long before EMFILE);
- **disk usage** — used/free bytes per data dir (summed across
  -workers like every other merged gauge);
- **cache occupancy vs budget** — `SeaweedFS_cache_used_bytes` already
  exists; `SeaweedFS_cache_budget_bytes` (set by util/chunk_cache at
  construction) completes the ratio.

Every probe is cheap, synchronous, and never raises into the recorder.

A copy of seaweedfs_tpu/stats/saturation.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import threading
import time

_lag_lock = threading.Lock()
_lag_max = 0.0
_lag_last = 0.0         # last flushed window max (peekable between snaps)

_exec_probe_running = False
_exec_wait_last = 0.0   # last measured executor queue wait (seconds)


def note_loop_lag(lag_s: float) -> None:
    """Fed by the timeline module's continuous lag-probe task."""
    global _lag_max
    with _lag_lock:
        if lag_s > _lag_max:
            _lag_max = lag_s


def sample_loop_lag() -> None:
    """Flush the max observed scheduling lag to the gauge (and reset
    the max, so each window reports its own worst case)."""
    global _lag_max, _lag_last
    from . import metrics
    if not metrics.HAVE_PROMETHEUS:
        return
    with _lag_lock:
        lag, _lag_max = _lag_max, 0.0
        _lag_last = lag
    metrics.EVENTLOOP_LAG.set(round(lag, 6))


def current_lag_s() -> float:
    """Live peek for the QoS shedder (seaweedfs_tpu_torch/qos/): the worst
    scheduling lag seen this window or the last flushed one —
    whichever is worse — WITHOUT resetting the running max."""
    with _lag_lock:
        return max(_lag_max, _lag_last)


def current_exec_wait_s() -> float:
    """Last measured executor queue wait (the QoS shedder's
    disk-path saturation signal)."""
    return _exec_wait_last


def sample_process() -> None:
    """Open-fd count (linux /proc; no-op elsewhere)."""
    from . import metrics
    if not metrics.HAVE_PROMETHEUS:
        return
    try:
        metrics.OPEN_FDS.set(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass


def disk_probe(paths: "list[str]"):
    """A probe closure sampling used/free bytes per data dir."""
    uniq = sorted(set(paths))

    def probe() -> None:
        from . import metrics
        if not metrics.HAVE_PROMETHEUS:
            return
        for p in uniq:
            try:
                u = shutil.disk_usage(p)
            except OSError:
                continue
            metrics.DISK_FREE_BYTES.labels(p).set(u.free)
            metrics.DISK_USED_BYTES.labels(p).set(u.used)

    probe.__name__ = "disk_probe"
    return probe


def start_executor_probe(loop, period_s: float = 10.0) -> None:
    """Periodically time a no-op through the default executor: the
    submit→run delay IS the queue wait a real pread would pay right
    now. Runs as a retained task on `loop`; idempotent per process."""
    global _exec_probe_running
    if _exec_probe_running:
        return
    _exec_probe_running = True

    async def probe_loop() -> None:
        from . import metrics
        while True:
            await asyncio.sleep(period_s)
            if not metrics.HAVE_PROMETHEUS:
                continue
            t0 = time.perf_counter()
            try:
                # cap the wait: a wedged pool must not wedge the probe —
                # the capped value still lands in the gauge as "at
                # least this saturated"
                await asyncio.wait_for(
                    asyncio.shield(
                        loop.run_in_executor(None, lambda: None)),  # weedlint: ignore[executor-ctx] probe measures RAW queue wait; a context copy would add the cost being measured and no span parenthood exists here
                    timeout=5.0)
            except asyncio.TimeoutError:
                pass
            global _exec_wait_last
            _exec_wait_last = time.perf_counter() - t0
            metrics.EXECUTOR_WAIT.set(round(_exec_wait_last, 6))
            pool = getattr(loop, "_default_executor", None)
            q = getattr(pool, "_work_queue", None)
            if q is not None:
                try:
                    metrics.EXECUTOR_QUEUE_DEPTH.set(q.qsize())
                except (AttributeError, NotImplementedError):
                    pass

    task = loop.create_task(probe_loop())
    # retained module-wide; dies with the loop at process exit

    def _done(_t) -> None:
        global _exec_probe_running
        _exec_probe_running = False

    task.add_done_callback(_done)
    global _exec_probe_task
    _exec_probe_task = task


def stop_executor_probe() -> None:
    """Cancel the probe task (daemon shutdown path)."""
    if _exec_probe_task is not None and not _exec_probe_task.done():
        _exec_probe_task.cancel()


_exec_probe_task = None
