"""Dump-on-demand profiling (util/pprof.py): dump_now() snapshots the
armed cProfile/tracemalloc profiles mid-flight and keeps sampling,
SIGUSR2 triggers the same dump, and /debug/pprof serves the armed
state (?dump=1 writes the files) on the live servers.

The cases of tests/test_pprof.py pointed at the port's util/pprof.py,
its cluster case on port volume servers (tests/test_torch_cluster_util.py).
Each case also arms the JAX package's util/pprof.py the same way, one
package at a time (a process holds one cProfile profiler), and holds
the port's answers, dump paths and dumped files to the reference's."""

from __future__ import annotations

import os
import pstats
import re
import signal
import time

import pytest

from seaweedfs_tpu.util import pprof as ref_pprof
from seaweedfs_tpu_torch.util import pprof

from test_torch_cluster_util import Cluster, run

BOTH = ((pprof, "port"), (ref_pprof, "ref"))


def _disarm(mod) -> None:
    """setup_profiling mutates module globals and starts tracemalloc;
    restore so the other package and other tests see an unarmed
    process."""
    import tracemalloc
    with mod._lock:
        prof = mod._cpu[0] if mod._cpu else None
    if prof is not None:
        prof.disable()
    mod._cpu = None
    mod._mem_path = ""
    if tracemalloc.is_tracing():
        tracemalloc.stop()


@pytest.fixture(autouse=True)
def _clean_module_state():
    yield
    for mod, _ in BOTH:
        _disarm(mod)


def _burn():
    return sum(i * i for i in range(20_000))


def _rel(out: dict, root: str) -> dict:
    """A dump_now() answer with its paths relative to `root`."""
    return {k: os.path.relpath(v, root) for k, v in out.items()}


def _funcs(path: str) -> "set[str]":
    return {fn for _, _, fn in pstats.Stats(path).stats}


MEM_LINE = re.compile(r"^.+:\d+: size=\d+(\.\d+)? [KMG]?i?B, count=\d+, "
                      r"average=\d+(\.\d+)? [KMG]?i?B$")


def test_dump_now_snapshots_mid_flight_and_keeps_profiling(tmp_path):
    seen = {}
    for mod, side in BOTH:
        root = tmp_path / side
        root.mkdir()
        cpu = str(root / "cpu.prof")
        mem = str(root / "mem.txt")
        mod.setup_profiling(cpu_profile=cpu, mem_profile=mem)
        assert mod.pprof_dict() == {"cpu": True, "mem": True}
        _burn()
        out = mod.dump_now()
        assert out == {"cpu": cpu, "mem": mem}
        assert os.path.getsize(cpu) > 0
        assert os.path.getsize(mem) > 0
        # profiling continued after the dump: a later snapshot has MORE
        # accumulated call data than the first
        first = os.path.getsize(cpu)
        for _ in range(5):
            _burn()
        again = mod.dump_now()
        assert os.path.getsize(cpu) >= first
        with open(mem) as f:
            lines = f.read().splitlines()
        assert lines and all(MEM_LINE.match(line) for line in lines), \
            lines[:3]
        seen[side] = (mod.pprof_dict(), _rel(out, str(root)),
                      _rel(again, str(root)), "_burn" in _funcs(cpu),
                      len(lines) <= 100)
        _disarm(mod)
    assert seen["port"] == seen["ref"]
    assert seen["port"][3], "the profile holds the burned function"


def test_worker_index_suffixes_dump_paths(tmp_path):
    assert pprof.profile_path("/x/p.out", 3) == "/x/p.out.w3"
    assert pprof.profile_path("/x/p.out", -1) == "/x/p.out"
    for path in ("/x/p.out", "rel/p", "p.w1", ""):
        for index in (-5, -1, 0, 1, 7, 123):
            assert pprof.profile_path(path, index) == \
                ref_pprof.profile_path(path, index)
    seen = {}
    for mod, side in BOTH:
        cpu = str(tmp_path / side / "w.prof")
        os.makedirs(os.path.dirname(cpu))
        mod.setup_profiling(cpu_profile=cpu, worker_index=1)
        out = mod.dump_now()
        assert out == {"cpu": cpu + ".w1"}
        assert os.path.exists(cpu + ".w1")
        seen[side] = _rel(out, str(tmp_path / side))
        _disarm(mod)
    assert seen["port"] == seen["ref"]


def test_sigusr2_dumps_on_demand(tmp_path):
    # the handler of the package armed last answers the signal: arm one
    # package, signal, disarm, then the other
    seen = {}
    for mod, side in BOTH:
        cpu = str(tmp_path / f"{side}.prof")
        mod.setup_profiling(cpu_profile=cpu)
        assert not os.path.exists(cpu)
        os.kill(os.getpid(), signal.SIGUSR2)
        # the handler runs synchronously on the main thread's next
        # bytecode
        for _ in range(100):
            if os.path.exists(cpu):
                break
            time.sleep(0.01)
        assert os.path.exists(cpu) and os.path.getsize(cpu) > 0
        seen[side] = (signal.getsignal(signal.SIGUSR2).__name__,
                      mod.pprof_dict())
        _disarm(mod)
    assert seen["port"] == seen["ref"]


def test_dump_now_unarmed_is_empty():
    assert pprof.dump_now() == {} == ref_pprof.dump_now()
    assert pprof.pprof_dict(dump=True) == {"cpu": False, "mem": False,
                                           "dumped": {}}
    for dump in (False, True):
        assert pprof.pprof_dict(dump=dump) == ref_pprof.pprof_dict(dump=dump)


def test_debug_pprof_route_reports_and_dumps(tmp_path):
    async def go():
        from seaweedfs_tpu.master.server import MasterServer as RefMaster
        async with Cluster(str(tmp_path), n_servers=1,
                           master_cls=RefMaster) as c:
            vs = c.servers[0]
            # the master is the JAX package's: it serves the reference's
            # handler from the reference's registry, the port volume
            # server the port's; each is armed in turn and must answer
            # alike
            urls = {"port": f"http://{vs.url}/debug/pprof",
                    "ref": f"http://{c.master.url}/debug/pprof"}
            seen = {}
            for mod, side in BOTH:
                # nothing armed: the route reports so without writing
                async with c.http.get(urls[side]) as r:
                    assert r.status == 200
                    unarmed = await r.json()
                assert unarmed == {"cpu": False, "mem": False}
                # arm mid-run, then dump through the route
                cpu = str(tmp_path / f"route-{side}.prof")
                mod.setup_profiling(cpu_profile=cpu)
                async with c.http.get(urls[side],
                                      params={"dump": "1"}) as r:
                    assert r.status == 200
                    body = await r.json()
                assert body["cpu"] and body["dumped"]["cpu"] == cpu
                assert os.path.exists(cpu)
                # the other package's route still reports nothing armed
                other = urls["ref" if side == "port" else "port"]
                async with c.http.get(other) as r:
                    assert (await r.json())["cpu"] is False
                _disarm(mod)
                body["dumped"] = _rel(body["dumped"], str(tmp_path))
                seen[side] = (unarmed, {**body, "dumped": {
                    k: v.replace(side, "*")
                    for k, v in body["dumped"].items()}})
            assert seen["port"] == seen["ref"]
    run(go())
