"""The benchmark's harness: one run of one cell.

Everything that belongs to one configuration, traffic mix, operation or
metric is found by its name in `BENCHMARK.json`:

    benchmark/configs/<config>.json   the deployment, as run
    benchmark/traffic/<traffic>.json  the mix; its "op" names
    benchmark/ops/<op>.py             the operation that drives it
    benchmark/metrics/<metric>.py     a reader of one metric (a metric
                                      named `a.b` is read by `a.b.py`,
                                      else by `a.py`)

A run builds the store from the seed (set-up), warms every shape the
mix uses, then measures for `--seconds`, keeping torch.profiler's
device trace of the window on a card. With `--trace 1` it also opens a
root span around each request, so that the program's own spans record,
and traces the host's operations besides. Once the
window has closed and the device's peak is read, the operation's check
holds what the window served to the bytes the seed wrote.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass

from . import build, faults, hostprobe

# modules that must not be loaded in a run: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "seaweedfs_tpu")

# spans the traced run keeps: room for every span of a window
TRACE_RING = 1 << 19


@dataclass
class Cell:
    name: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    built: build.Built | None = None


class Clock:
    """The window: `start()` opens it (after starting the profiler, where
    the run has one), requests start until `close`, and `closed()` stops
    the profiler at the close."""

    def __init__(self, seconds: float, recorder=None):
        self.seconds = seconds
        self.go = threading.Event()
        self.recorder = recorder
        self.open = self.close = 0.0
        self.trace_wall = (0.0, 0.0)
        self._trace_t0 = 0.0

    def start(self) -> None:
        if self.recorder is not None:
            self.recorder.start()
            self.trace_wall = (time.time(), 0.0)
            self._trace_t0 = time.perf_counter()
        self.open = time.perf_counter()
        self.close = self.open + self.seconds
        self.go.set()

    def wait_close(self) -> None:
        while True:
            left = self.close - time.perf_counter()
            if left <= 0:
                return
            time.sleep(min(left, 0.05))

    def closed(self) -> None:
        if self.recorder is not None and self.recorder.trace is None:
            self._sync()
            span = time.perf_counter() - self._trace_t0
            self.trace_wall = (self.trace_wall[0], time.time())
            self.recorder.stop(span)

    @staticmethod
    def _sync() -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@dataclass
class RunView:
    """What a metric's reader reads."""
    cell: Cell
    op: object
    outcome: object
    clock: Clock
    setup_s: float
    spans: list | None
    trace: object


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(root: str, spec: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return wl, cfg, traffic


def metrics_of(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: str, name: str):
    """The `read(run)` of a metric: metrics/<name>.py, else the file of
    the name's part before its first dot."""
    base = os.path.join(root, "benchmark", "metrics")
    for stem in (name, name.split(".", 1)[0]):
        path = os.path.join(base, stem + ".py")
        if os.path.exists(path):
            mod_name = "benchmark_metric_" + stem.replace(".", "_") \
                .replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, whole, is forbidden."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"


def written_bytes() -> dict:
    """What this process has written: through write calls (wchar) and
    to the storage layer (write_bytes), from /proc/self/io."""
    try:
        with open("/proc/self/io") as f:
            rows = dict(line.split(":") for line in f if ":" in line)
        return {k: int(rows[k]) for k in ("wchar", "write_bytes")}
    except (OSError, KeyError, ValueError):
        return {}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, fault: str, t_start: float, device) -> dict:
    """One run of one cell on `device`; returns the result line's object
    (with its checks last) without printing it."""
    import torch
    spec = load_spec(root)
    wl, cfg, traffic = resolve(root, spec, workload)
    op = importlib.import_module(f"benchmark.ops.{traffic['op']}")
    cell = Cell(workload, cfg, traffic, seed, seconds, trace, device)
    cuda = torch.device(device).type == "cuda"
    workdir = tempfile.mkdtemp(prefix="bench-store-")
    try:
        cell.built = build.build(cfg, traffic, seed, workdir, device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        op.warm(cell)
        recorder = None
        if trace:
            from seaweedfs_tpu_torch.util import tracing
            tracing.init(sample=1.0, ring=TRACE_RING)
            tracing.reset()
        if trace or cuda:
            # every run on the card keeps the device's trace of its
            # window: end-to-end metrics of the card are read from it
            from .devtrace import Recorder
            recorder = Recorder(cuda, host=trace)
        if cuda:
            torch.cuda.synchronize()
        clock = Clock(seconds, recorder)
        # set-up ends here: what follows until the window opens is the
        # benchmark's own (the host probes, the profiler's start)
        ready = time.perf_counter()
        copy_before = hostprobe.copy_GBps()
        loop_before = hostprobe.loop_Msteps()
        host_before = hostprobe.snapshot()
        with faults.applied(fault, cell):
            outcome = op.window(cell, clock)
        host = hostprobe.between(host_before, hostprobe.snapshot())
        host["copy_GBps_before"] = copy_before
        host["copy_GBps_after"] = hostprobe.copy_GBps()
        host["loop_Msteps_before"] = loop_before
        host["loop_Msteps_after"] = hostprobe.loop_Msteps()
        if hasattr(outcome, "requests"):
            host["done_by_slice"] = hostprobe.done_by_slice(
                outcome.requests, clock.open, clock.close)
        setup_s = ready - t_start
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        spans = None
        if trace:
            from seaweedfs_tpu_torch.util import tracing
            spans = [s for g in tracing.traces_dict(
                recent=1 << 30, slowest=0)["traces"] for s in g["spans"]]
        view = RunView(cell, op, outcome, clock, setup_s, spans,
                       recorder.trace if recorder else None)
        metrics = {}
        for m in metrics_of(spec, workload, trace):
            value = reader(root, m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if cuda else "cpu",
               "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
               "count": 1 if cuda else 0,
               "memory_peak_bytes": int(peak)}
        result = {"attempted": len(outcome.requests),
                  "failed": sum(1 for r in outcome.requests if not r[2]),
                  "metrics": metrics, "device": dev}
        if trace and view.trace is not None:
            dev["busy_s"] = view.trace.busy_s()
            dev["window_s"] = view.trace.window_s
            result["breakdown"] = {
                "device_ops": view.trace.top_device_ops(),
                "idle_gaps": view.trace.idle_gaps()}
        if cuda:
            dev["power"] = power_limit()
        dev["setup_split_s"] = cell.built.split
        result["host"] = host
        if outcome.errors:
            result["errors"] = outcome.errors
        checks = op.check(cell, outcome)
        result["correct"] = (result["failed"] == 0 and all(
            v <= lim for v, lim in checks.values()))
        result["checks"] = {k: {"value": v, "limit": lim}
                            for k, (v, lim) in checks.items()}
        return result
    finally:
        if cell.built is not None:
            cell.built.store.close()
        shutil.rmtree(workdir, ignore_errors=True)


def main(root: str, workload: str, seed: int, seconds: float,
         trace: bool, fault: str, t_start: float) -> int:
    set_cache_dirs(root)
    spec = load_spec(root)
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        print(f"no workload {workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(wl["chips"]):
        print(f"{workload} needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(root, workload, seed, seconds, trace, fault, t_start,
                      "cuda")
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded in the run: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    result["device"]["written"] = written_bytes()
    line = {"correct": result.pop("correct")}
    checks = result.pop("checks")
    line.update(result)
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0
