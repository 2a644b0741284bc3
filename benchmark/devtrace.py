"""The device trace of a run's window, read from torch.profiler.

The profiler records the window; its Chrome trace is written to a file
under the temporary directory, read back and deleted. From it come the
device's operations (kernels, copies, fills) with their times and bytes,
the union of the intervals in which the device was busy, and what the
host was doing in the longest gaps between them.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


@dataclass
class Op:
    name: str
    cat: str
    start_us: float
    dur_us: float
    nbytes: int = 0


@dataclass
class DeviceTrace:
    device_ops: list[Op] = field(default_factory=list)
    host_ops: list[Op] = field(default_factory=list)
    window_s: float = 0.0     # the traced window, by the host's clock

    def ops(self, pattern: str) -> list[Op]:
        """Device operations whose name contains `pattern`."""
        return [o for o in self.device_ops if pattern in o.name]

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device operations' intervals, in order (us)."""
        spans = sorted((o.start_us, o.start_us + o.dur_us)
                       for o in self.device_ops if o.dur_us > 0)
        out: list[list[float]] = []
        for lo, hi in spans:
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return [(lo, hi) for lo, hi in out]

    def top_device_ops(self, n: int = 10) -> list[list]:
        """[name, seconds] of the device operations that took most time,
        summed by name."""
        total: dict[str, float] = {}
        for o in self.device_ops:
            key = short_name(o.name)
            total[key] = total.get(key, 0.0) + o.dur_us / 1e6
        return [[k, v] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """[what the host was doing, seconds] of the n longest gaps in
        which the device ran nothing, between the trace's first and
        last event. The innermost host operation that covers at least
        half of a gap names it, else the one that covers most of it; a
        gap no traced host operation covers is the host's Python (file
        reads, parsing, hashing)."""
        busy = self.busy_intervals()
        every = self.device_ops + self.host_ops
        if not every:
            return []
        lo = min(o.start_us for o in every)
        hi = max(o.start_us + o.dur_us for o in every)
        gaps, at = [], lo
        for b0, b1 in busy:
            if b0 > at:
                gaps.append((at, b0))
            at = max(at, b1)
        if hi > at:
            gaps.append((at, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host_ops, key=lambda o: o.start_us)
        starts = [o.start_us for o in host]
        longest = max((o.dur_us for o in host), default=0.0)
        out = []
        for g0, g1 in gaps[:n]:
            covers = []
            i = bisect.bisect_left(starts, g0 - longest)
            while i < len(host) and host[i].start_us < g1:
                o = host[i]
                c = min(g1, o.start_us + o.dur_us) - max(g0, o.start_us)
                if c > 0:
                    covers.append((c, o))
                i += 1
            half = [o for c, o in covers if 2 * c >= g1 - g0]
            if half:
                best = "host " + short_name(
                    min(half, key=lambda o: o.dur_us).name)
            elif covers:
                best = "host " + short_name(max(covers,
                                                key=lambda co: co[0])[1].name)
            else:
                best = "host python (no traced op)"
            out.append([best, (g1 - g0) / 1e6])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"\(.*$", "", name).strip()
    return re.sub(r"^void ", "", name)[:120]


def read_chrome_trace(path: str, window_s: float) -> DeviceTrace:
    with open(path) as f:
        doc = json.load(f)
    tr = DeviceTrace(window_s=window_s)
    for e in doc.get("traceEvents", ()):
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if cat in DEVICE_CATS:
            args = e.get("args") or {}
            tr.device_ops.append(Op(e.get("name", ""), cat, float(e["ts"]),
                                    float(e["dur"]),
                                    int(args.get("bytes", 0) or 0)))
        elif cat in HOST_CATS:
            tr.host_ops.append(Op(e.get("name", ""), cat, float(e["ts"]),
                                  float(e["dur"])))
    return tr


class Recorder:
    """torch.profiler over the window: `start()` before it opens,
    `stop()` after it closes, then `trace` holds what it saw. Without
    `host` it records the device's operations and the runtime's calls
    alone, not every host operator."""

    def __init__(self, cuda: bool, host: bool = True):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] if host or not cuda else []
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.trace: DeviceTrace | None = None

    def start(self) -> None:
        self._prof.__enter__()

    def stop(self, window_s: float) -> None:
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.trace = read_chrome_trace(path, window_s)
        finally:
            os.remove(path)
