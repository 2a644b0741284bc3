"""CPU/memory profiling behind flags on every long-running command.

Reference: weed/util/pprof.go `SetupProfiling(cpuProfile, memProfile)`,
wired at command/master.go:74-75, volume.go, mount_std.go:28. Python
analog: cProfile stats dumped at exit for CPU, tracemalloc top-25 for
memory.

Under `-workers N` every worker process runs this same setup with the
same flag values; each dump path is therefore suffixed `.w<index>`
(e.g. `prof.out.w1`) so N workers don't clobber one file — the
supervisor's own process (workerIndex < 0) keeps the bare path.

Dumps happen at atexit AND on demand: a SIGKILLed or wedged worker
would lose an atexit-only profile, so ``dump_now()`` snapshots both
profiles mid-flight — reachable as ``/debug/pprof?dump=1`` (the volume
server fans it across ``-workers`` siblings) and on SIGUSR2 (the
classic "the process is wedged, dump what you have" escape hatch:
``kill -USR2 <pid>``). The cProfile dump disables the profiler only
for the dump_stats call and re-enables it, so sampling continues.

A copy of seaweedfs_tpu/util/pprof.py in the PyTorch port.
"""

from __future__ import annotations

import atexit
import signal
import threading

# (profile, dump path) registered by setup_profiling in THIS process
_cpu: "tuple[object, str] | None" = None
_mem_path = ""
_lock = threading.Lock()


def profile_path(path: str, worker_index: int = -1) -> str:
    """The actual dump path: `.w<index>`-suffixed under -workers."""
    return f"{path}.w{worker_index}" if worker_index >= 0 else path


def _dump_cpu(final: bool = False) -> "str | None":
    with _lock:
        if _cpu is None:
            return None
        prof, path = _cpu
        prof.disable()
        try:
            prof.dump_stats(path)
        finally:
            if not final:
                prof.enable()
    return path


def _dump_mem() -> "str | None":
    if not _mem_path:
        return None
    import tracemalloc
    if not tracemalloc.is_tracing():
        return None
    snap = tracemalloc.take_snapshot()
    with _lock:
        with open(_mem_path, "w") as f:
            for stat in snap.statistics("lineno")[:100]:
                f.write(f"{stat}\n")
    return _mem_path


def dump_now() -> dict:
    """Snapshot every armed profile to its path NOW and keep
    profiling. Returns {"cpu": path, "mem": path} for the dumps that
    actually happened ({} when neither flag was set)."""
    out: dict[str, str] = {}
    cpu = _dump_cpu()
    if cpu:
        out["cpu"] = cpu
    mem = _dump_mem()
    if mem:
        out["mem"] = mem
    return out


def _on_sigusr2(_signum, _frame) -> None:
    dump_now()


def setup_profiling(cpu_profile: str = "", mem_profile: str = "",
                    worker_index: int = -1) -> None:
    global _cpu, _mem_path
    if cpu_profile:
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
        _cpu = (prof, profile_path(cpu_profile, worker_index))
        atexit.register(_dump_cpu, final=True)
    if mem_profile:
        import tracemalloc
        tracemalloc.start(25)
        _mem_path = profile_path(mem_profile, worker_index)
        atexit.register(_dump_mem)
    if cpu_profile or mem_profile:
        try:
            signal.signal(signal.SIGUSR2, _on_sigusr2)
        except ValueError:
            pass    # not the main thread (embedded/test loop): HTTP
            # dump-on-demand still works


def debug_handler():
    """One aiohttp /debug/pprof handler — GET reports what's armed,
    ``?dump=1`` snapshots to disk mid-flight. Registered by every
    non-worker-aggregating server; the volume server has a
    -workers-fanning twin."""
    from aiohttp import web
    from . import tracing

    async def h_pprof(req):
        dump = req.query.get("dump", "") in ("1", "true")
        # executor hop: the mem dump writes a file
        body = await tracing.run_in_executor(
            lambda: pprof_dict(dump=dump))
        return web.json_response(body)

    return h_pprof


def pprof_dict(dump: bool = False) -> dict:
    """The /debug/pprof body: which profiles are armed, and — with
    dump=True — the paths just written."""
    out: dict = {"cpu": bool(_cpu), "mem": bool(_mem_path)}
    if dump:
        out["dumped"] = dump_now()
    return out
