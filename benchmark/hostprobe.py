"""What the host did around a run's window, to tell a slow run's cause:
this process's CPU time, page faults and context switches over the
window, a fixed host memory copy and a fixed pure-Python loop timed
before and after it, and the requests done in each slice of the window.
None of it is a metric; the result line carries it under "host"."""

from __future__ import annotations

import os
import resource
import time

import numpy as np

# the copy probe: PROBE_BYTES copied PROBE_ROUNDS times
PROBE_BYTES = 64 << 20
PROBE_ROUNDS = 4
# the interpreter probe: a loop of this many steps
LOOP_STEPS = 1 << 20
# the slices of the window that done requests are counted in, in seconds
SLICE_S = 5.0


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "cpu": ru.ru_utime + ru.ru_stime,
            "minflt": ru.ru_minflt, "majflt": ru.ru_majflt,
            "nvcsw": ru.ru_nvcsw, "nivcsw": ru.ru_nivcsw}


def copy_GBps() -> float:
    """Host memory copy rate of a fixed probe, in GB/s."""
    src = np.ones(PROBE_BYTES, np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)
    t = time.perf_counter()
    for _ in range(PROBE_ROUNDS):
        np.copyto(dst, src)
    return PROBE_BYTES * PROBE_ROUNDS / (time.perf_counter() - t) / 1e9


def loop_Msteps() -> float:
    """Steps a second, in millions, of a fixed pure-Python loop: how fast
    one core runs the interpreter."""
    t = time.perf_counter()
    x = 0
    for i in range(LOOP_STEPS):
        x ^= i
    return LOOP_STEPS / (time.perf_counter() - t) / 1e6


def between(a: dict, b: dict) -> dict:
    """What the host did from snapshot `a` to snapshot `b`."""
    return {"wall_s": b["t"] - a["t"], "process_cpu_s": b["cpu"] - a["cpu"],
            "minor_faults": b["minflt"] - a["minflt"],
            "major_faults": b["majflt"] - a["majflt"],
            "voluntary_switches": b["nvcsw"] - a["nvcsw"],
            "involuntary_switches": b["nivcsw"] - a["nivcsw"],
            "cores": len(os.sched_getaffinity(0))}


def done_by_slice(requests, t0: float, t1: float) -> list[int]:
    """Requests (start, end, ok, ...) that ended well in each SLICE_S of
    [t0, t1]."""
    n = max(1, int(-(-(t1 - t0) // SLICE_S)))
    counts = [0] * n
    for r in requests:
        if r[2] and t0 <= r[1] <= t1:
            counts[min(n - 1, int((r[1] - t0) // SLICE_S))] += 1
    return counts
