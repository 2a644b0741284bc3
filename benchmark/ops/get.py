"""GETs of parts through `Store.read_needle`, as a volume server serves
them to S3 clients.

A closed loop: each of "clients" threads sends its next GET when its
last returns, for a part drawn uniformly at random, each GET timed from
call to return.

Every served part's length is checked. Each client keeps a sample of
its GETs, drawn from the seed uniformly over all it served in the
window (its share of "samples", by reservoir sampling), and once the
window has closed every sampled part is compared byte for byte with the
bytes the set-up wrote.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np

from .. import data, roofline


@dataclass
class Outcome:
    # (start, end, ok, part index) of every GET, by the host's clock
    requests: list = field(default_factory=list)
    samples: list = field(default_factory=list)     # (part index, bytes)
    wrong_sizes: int = 0
    errors: list = field(default_factory=list)
    launches: int = 0            # K1 launches in the window

    def in_window(self, t0: float, t1: float) -> list:
        return [r for r in self.requests if t0 <= r[1] <= t1]


def parts_of(cell) -> list:
    return [p for plan in cell.built.plans for p in plan.parts]


class Keys:
    """The parts one client asks for, uniformly at random."""

    def __init__(self, n: int, r: np.random.Generator):
        self.r = r
        self.n = n
        self.buf: list[int] = []

    def __next__(self) -> int:
        if not self.buf:
            self.buf = list(self.r.integers(0, self.n, 256))[::-1]
        return int(self.buf.pop())


class Reservoir:
    """A sample of k of one client's GETs, uniform over all it offers:
    the n-th (from 0) takes a slot with chance k / (n + 1)."""

    def __init__(self, k: int, r: np.random.Generator):
        self.k = k
        self.r = r
        self.n = 0
        self.kept: list = []

    def offer(self, item) -> None:
        if self.n < self.k:
            self.kept.append(item)
        else:
            j = int(self.r.integers(0, self.n + 1))
            if j < self.k:
                self.kept[j] = item
        self.n += 1


def _get(cell, part, traced: bool):
    from seaweedfs_tpu_torch.util import tracing
    store = cell.built.store
    if not traced:
        return store.read_needle(part.vid, part.nid, part.cookie)
    with tracing.start_root("bench", "get"):
        return store.read_needle(part.vid, part.nid, part.cookie)


def warm(cell) -> None:
    """GET every part once, over the cell's clients at once: every
    interval shape, recover matrix and kernel the window can ask for."""
    parts = parts_of(cell)
    clients = int(cell.traffic["clients"])
    errs: list = []

    def run(c: int) -> None:
        try:
            for p in parts[c::clients]:
                n = _get(cell, p, False)
                if len(n.data) != p.size:
                    raise RuntimeError(f"warm-up GET of needle {p.nid}: "
                                       f"{len(n.data)} bytes, not {p.size}")
        except Exception as e:  # noqa: BLE001 — reported by the caller
            errs.append(e)

    ts = [threading.Thread(target=run, args=(c,), daemon=True)
          for c in range(clients)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]


def window(cell, clock) -> Outcome:
    """Drive the window: GETs start until clock.close and each one
    started runs to its end."""
    from seaweedfs_tpu_torch.ops import gf256_cuda
    traffic = cell.traffic
    parts = parts_of(cell)
    out = Outcome()
    lock = threading.Lock()
    traced = cell.trace
    clients = int(traffic["clients"])
    per = max(1, int(traffic["samples"]) // clients)
    kept: list[Reservoir] = []

    def client(c: int) -> None:
        keys = Keys(len(parts), data.rng(cell.seed, data.STREAM_CLIENT, c))
        sample = Reservoir(per, data.rng(cell.seed, data.STREAM_SAMPLE, c))
        with lock:
            kept.append(sample)
        clock.go.wait()
        while True:
            t_start = time.perf_counter()
            if t_start >= clock.close:
                return
            i = next(keys)
            p = parts[i]
            ok, body, err = True, None, None
            try:
                body = _get(cell, p, traced).data
            except Exception as e:  # noqa: BLE001 — a failed GET counts
                ok, err = False, repr(e)
            t_end = time.perf_counter()
            if ok and len(body) == p.size:
                sample.offer((i, body))
            with lock:
                out.requests.append((t_start, t_end, ok, i))
                if err is not None and len(out.errors) < 8:
                    out.errors.append(err)
                if ok and len(body) != p.size:
                    out.wrong_sizes += 1

    ts = [threading.Thread(target=client, args=(c,), daemon=True)
          for c in range(clients)]
    for t in ts:
        t.start()
    before = gf256_cuda.launches
    clock.start()
    clock.wait_close()
    out.launches = gf256_cuda.launches - before
    clock.closed()
    for t in ts:
        t.join()
    out.samples = [s for r in kept for s in r.kept]
    return out


def k1_bytes(run) -> float | None:
    """HBM bytes of the card's recovers in the traced window: each
    `ec.recover` span at or above the configuration's small_recover_bytes
    ran K1 on (1, 10, L) survivors into one row of L bytes."""
    if run.spans is None:
        return None
    lo, hi = run.clock.trace_wall
    threshold = run.cell.cfg["small_recover_bytes"]
    k = run.cell.cfg["data_shards"]
    total = 0
    for s in run.spans:
        if s["tier"] == "ec" and s["op"] == "recover" \
                and s["bytes"] >= threshold and lo <= s["start_ms"] / 1e3 \
                and s["start_ms"] / 1e3 + s["dur_ms"] / 1e3 <= hi:
            total += roofline.transform_bytes(k, 1, s["bytes"])
    return float(total) or None


def check(cell, out: Outcome) -> dict:
    """The numbers `correct` is judged by, each with its limit."""
    parts = parts_of(cell)
    mismatched = 0
    for i, body in out.samples:
        p = parts[i]
        want = cell.built.buffers[p.vid][p.start:p.start + p.size]
        if body != want.tobytes():
            mismatched += 1
    failed = sum(1 for r in out.requests if not r[2])
    return {"failed_gets": (failed, 0),
            "wrong_sizes": (out.wrong_sizes, 0),
            "mismatched_parts": (mismatched, 0),
            "no_parts_compared": (int(not out.samples), 0)}
