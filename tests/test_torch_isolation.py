"""The PyTorch/CUDA port stands alone: importing any of its modules, or
chip_smoke.py, loads neither jax nor the JAX package (seaweedfs_tpu),
builds no kernel and no native host library, creates no process group,
and no source file of the port imports either. Running the port's host
C routines maps its own library, never the JAX package's."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "seaweedfs_tpu_torch")


def _port_files() -> list[str]:
    out = []
    for root, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build"))
        out += [os.path.join(root, f) for f in sorted(files)
                if f.endswith(".py")]
    return out + [os.path.join(REPO, "chip_smoke.py")]


def _module_name(path: str) -> str:
    rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
    return rel[:-len(".__init__")] if rel.endswith(".__init__") else rel


def _forbidden(name: str) -> bool:
    """jax, jaxlib or the JAX package — but not seaweedfs_tpu_torch."""
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "seaweedfs_tpu")


def test_forbidden_prefix_rule():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("seaweedfs_tpu") and _forbidden("seaweedfs_tpu.ec.gf")
    assert not _forbidden("seaweedfs_tpu_torch")
    assert not _forbidden("seaweedfs_tpu_torch.ec.gf")


# the filer stores whose module imports its client library at the top,
# as the reference's do: without the library the import fails, and
# filerstore._load_builtin leaves the store unregistered
GATED_STORES = {"seaweedfs_tpu_torch.filer.stores.redis_store": "redis",
                "seaweedfs_tpu_torch.filer.stores.etcd_store": "etcd3",
                "seaweedfs_tpu_torch.filer.stores.cassandra_store":
                    "cassandra",
                "seaweedfs_tpu_torch.filer.stores.tikv_store":
                    "tikv_client"}


# the gateways, replication and K5's wrapper
GATEWAY_MODULES = ("seaweedfs_tpu_torch.s3",
                   "seaweedfs_tpu_torch.s3.auth",
                   "seaweedfs_tpu_torch.s3.gateway",
                   "seaweedfs_tpu_torch.server.webdav_server",
                   "seaweedfs_tpu_torch.replication",
                   "seaweedfs_tpu_torch.replication.source",
                   "seaweedfs_tpu_torch.replication.sink",
                   "seaweedfs_tpu_torch.replication.replicator",
                   "seaweedfs_tpu_torch.replication.runner",
                   "seaweedfs_tpu_torch.replication.sub",
                   "seaweedfs_tpu_torch.replication.cloud_sinks",
                   "seaweedfs_tpu_torch.ops.crc32c_cuda")


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    mods = [_module_name(p) for p in _port_files()]
    code = (
        "import importlib, json, sys\n"
        "gated = {}\n"
        f"for m in {mods!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        f"    except ImportError as e:\n"
        f"        if m not in {sorted(GATED_STORES)!r}:\n"
        "            raise\n"
        "        gated[m] = e.name\n"
        "from seaweedfs_tpu_torch.ops import _build\n"
        "from seaweedfs_tpu_torch.native import build as native\n"
        "import torch.distributed as dist\n"
        "print(json.dumps({'modules': sorted(sys.modules),\n"
        "                  'gated': gated,\n"
        "                  'loaded': sorted(_build._loaded),\n"
        "                  'native': native.loaded(),\n"
        "                  'group': dist.is_initialized()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("seaweedfs_tpu_torch.ec.pipeline", "chip_smoke",
                "seaweedfs_tpu_torch.parallel.mesh",
                "seaweedfs_tpu_torch.parallel.dist",
                "seaweedfs_tpu_torch.entry",
                "seaweedfs_tpu_torch.storage.store",
                "seaweedfs_tpu_torch.ec.ec_volume",
                "seaweedfs_tpu_torch.ec.scrub",
                "seaweedfs_tpu_torch.ec.encoder_cpu",
                "seaweedfs_tpu_torch.stats.metrics",
                "seaweedfs_tpu_torch.cli",
                "seaweedfs_tpu_torch.server.volume_server",
                "seaweedfs_tpu_torch.server.fasthttp",
                "seaweedfs_tpu_torch.server.frameserver",
                "seaweedfs_tpu_torch.util.client",
                "seaweedfs_tpu_torch.ops.gf256_mxu",
                "seaweedfs_tpu_torch.storage.vacuum",
                "seaweedfs_tpu_torch.storage.volume_backup",
                "seaweedfs_tpu_torch.storage.volume_tier",
                "seaweedfs_tpu_torch.query.json_query",
                "seaweedfs_tpu_torch.stats.slo",
                "seaweedfs_tpu_torch.stats.profiler",
                "seaweedfs_tpu_torch.util.pprof",
                "seaweedfs_tpu_torch.master.server",
                "seaweedfs_tpu_torch.master.election",
                "seaweedfs_tpu_torch.topology.layout",
                "seaweedfs_tpu_torch.autopilot.controller",
                "seaweedfs_tpu_torch.shell.runner",
                "seaweedfs_tpu_torch.stats.introspect",
                "seaweedfs_tpu_torch.util.masterclient",
                "seaweedfs_tpu_torch.filer.entry",
                "seaweedfs_tpu_torch.filer.filechunks",
                "seaweedfs_tpu_torch.filer.stream",
                "seaweedfs_tpu_torch.filer.filerstore",
                "seaweedfs_tpu_torch.filer.filer",
                "seaweedfs_tpu_torch.filer.shard",
                "seaweedfs_tpu_torch.filer.stores.memory_store",
                "seaweedfs_tpu_torch.filer.stores.leveldb_store",
                "seaweedfs_tpu_torch.filer.stores.leveldb2_store",
                "seaweedfs_tpu_torch.filer.stores.sqlite_store",
                "seaweedfs_tpu_torch.filer.stores.abstract_sql_store",
                "seaweedfs_tpu_torch.notification.queues",
                "seaweedfs_tpu_torch.notification.brokers",
                "seaweedfs_tpu_torch.server.filer_server",
                *GATEWAY_MODULES, *MOUNT_MODULES, *BENCH_MODULES):
        assert mod in report["modules"], mod
    # a gated store fails on its own client library only
    for mod, missing in report["gated"].items():
        assert missing == GATED_STORES[mod], (mod, missing)
    leaked = [m for m in report["modules"] if _forbidden(m)]
    assert leaked == [], leaked
    assert report["loaded"] == []
    assert report["native"] is False
    assert report["group"] is False


def test_cli_and_volume_server_alone_load_no_jax():
    """The volume server's entry points on their own: importing the CLI
    and the server and building the CLI's parser loads no jax and
    nothing of seaweedfs_tpu, builds nothing and starts no server."""
    code = (
        "import json, sys\n"
        "import seaweedfs_tpu_torch.cli as cli\n"
        "import seaweedfs_tpu_torch.server.volume_server\n"
        "cli.build_parser().parse_args(['volume', '-ecBackend', 'cpu'])\n"
        "from seaweedfs_tpu_torch.ops import _build\n"
        "print(json.dumps({'modules': sorted(sys.modules),\n"
        "                  'loaded': sorted(_build._loaded)}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in report["modules"] if _forbidden(m)] == []
    assert "seaweedfs_tpu_torch.server.wire" in report["modules"]
    assert report["loaded"] == []


@pytest.mark.parametrize("module", [
    "seaweedfs_tpu_torch.master.server",
    "seaweedfs_tpu_torch.autopilot",
    "seaweedfs_tpu_torch.shell.runner",
    "seaweedfs_tpu_torch.stats.introspect",
])
def test_control_plane_module_alone_loads_no_jax(module):
    """Each module of the port's control plane, imported alone in a
    fresh process, loads no jax and nothing of seaweedfs_tpu."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    modules = json.loads(proc.stdout.strip().splitlines()[-1])
    assert module in modules
    assert [m for m in modules if _forbidden(m)] == []


@pytest.mark.parametrize("module", [
    "seaweedfs_tpu_torch.filer.entry",
    "seaweedfs_tpu_torch.filer.filechunks",
    "seaweedfs_tpu_torch.filer.stream",
    "seaweedfs_tpu_torch.filer.filerstore",
    "seaweedfs_tpu_torch.filer.filer",
    "seaweedfs_tpu_torch.filer.shard",
    "seaweedfs_tpu_torch.filer.stores.memory_store",
    "seaweedfs_tpu_torch.filer.stores.leveldb_store",
    "seaweedfs_tpu_torch.filer.stores.leveldb2_store",
    "seaweedfs_tpu_torch.filer.stores.sqlite_store",
    "seaweedfs_tpu_torch.filer.stores.abstract_sql_store",
    "seaweedfs_tpu_torch.notification",
    "seaweedfs_tpu_torch.notification.queues",
    "seaweedfs_tpu_torch.notification.brokers",
    "seaweedfs_tpu_torch.server.filer_server",
])
def test_filer_module_alone_loads_no_jax(module):
    """Each module of the port's filer tier, imported alone in a fresh
    process, loads no jax and nothing of seaweedfs_tpu."""
    test_control_plane_module_alone_loads_no_jax(module)


@pytest.mark.parametrize("module", GATEWAY_MODULES)
def test_gateway_module_alone_loads_no_jax(module):
    """Each module of the port's gateways and replication, and K5's
    wrapper, imported alone in a fresh process, loads no jax and nothing
    of seaweedfs_tpu."""
    test_control_plane_module_alone_loads_no_jax(module)


MOUNT_MODULES = ("seaweedfs_tpu_torch.mount",
                 "seaweedfs_tpu_torch.mount.dirty_pages",
                 "seaweedfs_tpu_torch.mount.dir",
                 "seaweedfs_tpu_torch.mount.file",
                 "seaweedfs_tpu_torch.mount.wfs",
                 "seaweedfs_tpu_torch.mount.fusekernel",
                 "seaweedfs_tpu_torch.mount.fuse_adapter")


@pytest.mark.parametrize("module", MOUNT_MODULES)
def test_mount_module_alone_loads_no_jax(module):
    """Each module of the port's mount (its nodes, the /dev/fuse binding
    and the adapter), imported alone in a fresh process, loads no jax and
    nothing of seaweedfs_tpu."""
    test_control_plane_module_alone_loads_no_jax(module)


# the benchmark entry points
BENCH_MODULES = ("seaweedfs_tpu_torch.tools.bench",
                 "seaweedfs_tpu_torch.tools.bench_ec",
                 "seaweedfs_tpu_torch.tools.bench_pipeline",
                 "seaweedfs_tpu_torch.tools.bench_needle")


@pytest.mark.parametrize("module", BENCH_MODULES)
def test_bench_module_alone_loads_no_jax(module):
    """Each benchmark entry point of the port, imported alone in a fresh
    process, loads no jax and nothing of seaweedfs_tpu."""
    test_control_plane_module_alone_loads_no_jax(module)


def _imported(log: str) -> list[str]:
    return [line.rsplit("|", 1)[-1].strip() for line in log.splitlines()
            if line.startswith("import time:")]


def test_bench_ec_child_loads_no_jax():
    """bench-ec's child process (`python -m seaweedfs_tpu_torch.tools.bench
    --child`), which runs every stage on the plain versions here, imports
    no jax and nothing of seaweedfs_tpu, nor anything of the repo's
    tools/ package: -X importtime lists every module it imports."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(SWTPU_TORCH_EC_BACKEND="cpu", OMP_NUM_THREADS="1",
               SWTPU_TORCH_BENCH_BYTES=str(128 << 10),
               SWTPU_TORCH_BENCH_CHILD_S="150")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "seaweedfs_tpu_torch.tools.bench", "--child"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    stages = [json.loads(ln).get("stage") for ln in proc.stdout.splitlines()]
    assert {"oracle", "batched", "crc", "done"} <= set(stages)
    imported = _imported(proc.stderr)
    for mod in ("seaweedfs_tpu_torch.ops.gf256_mxu",
                "seaweedfs_tpu_torch.ops.crc32c_cuda",
                "seaweedfs_tpu_torch.parallel.mesh",
                "seaweedfs_tpu_torch.util.crc32c"):
        assert mod in imported, mod
    assert [m for m in imported
            if _forbidden(m) or m.split(".")[0] == "tools"] == []


def test_bench_needle_daemons_load_no_jax(monkeypatch, tmp_path):
    """bench_needle's daemons (the port's master and volume server)
    import no jax and nothing of seaweedfs_tpu: PYTHONPROFILEIMPORTTIME=1
    puts every import in their logs."""
    from seaweedfs_tpu_torch.tools import bench_needle
    from test_torch_tools import free_port_block

    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    row = bench_needle.bench_one(1, 50, 512, 4,
                                 base_port=free_port_block(2),
                                 tmp=str(tmp_path))
    assert row["write_rps"] > 0
    for log in ("proc0.log", "proc1.log"):
        with open(tmp_path / log) as f:
            imported = _imported(f.read())
        assert "seaweedfs_tpu_torch.security.tls" in imported, log
        assert [m for m in imported if _forbidden(m)] == [], log


def test_every_filer_store_loads_no_jax(tmp_path):
    """create_store of every store name the reference knows (the gated
    ones fail with "unknown filer store" where their client library is
    missing, as the reference's do) leaves nothing of jax or
    seaweedfs_tpu in sys.modules: _load_builtin imports the gated
    stores by the port's own name."""
    code = (
        "import json, os, sys\n"
        "from seaweedfs_tpu_torch.filer.filerstore import (\n"
        "    available_stores, create_store)\n"
        "from seaweedfs_tpu_torch.cli import _store_kwargs\n"
        "made, refused = [], []\n"
        "for name in ['memory', 'leveldb', 'leveldb2', 'sqlite', 'sql',\n"
        "             'redis', 'etcd', 'cassandra', 'tikv', 'mysql',\n"
        "             'postgres']:\n"
        "    path = os.path.join(sys.argv[1], name)\n"
        "    try:\n"
        "        create_store(name, **_store_kwargs(name, path))\n"
        "        made.append(name)\n"
        "    except ValueError:\n"
        "        refused.append(name)\n"
        "print(json.dumps({'modules': sorted(sys.modules), 'made': made,\n"
        "                  'refused': refused,\n"
        "                  'available': available_stores()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [m for m in report["modules"] if _forbidden(m)] == []
    assert {"memory", "leveldb", "leveldb2", "sqlite", "sql"} <= \
        set(report["made"])
    assert sorted(report["made"]) == sorted(report["available"])


@pytest.mark.parametrize("cmd", ["master", "shell", "filer", "filer.copy",
                                 "s3", "webdav", "server",
                                 "filer.replicate", "mount", "bench-ec"])
def test_cli_master_and_shell_entry_points_load_no_jax(cmd):
    """`python -m seaweedfs_tpu_torch.cli master -h` (and the same for
    `shell`, `filer`, `filer.copy`, `s3`, `webdav`, `server`,
    `filer.replicate`, `mount` and `bench-ec`) imports no jax and nothing of seaweedfs_tpu: -X
    importtime lists every module the command's process imports."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "seaweedfs_tpu_torch.cli",
         cmd, "-h"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert f"weed-torch {cmd}" in proc.stdout
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    # the module runs as __main__; its own imports are listed
    assert "seaweedfs_tpu_torch.security.tls" in imported
    assert [m for m in imported if _forbidden(m)] == []


def test_port_maps_its_own_native_library_only(tmp_path):
    """A store round trip in the port (CRC32C on write and read, the
    native needle map, a host GF(256) recover) maps the port's native
    library from seaweedfs_tpu_torch/_build/ and nothing from the JAX
    package's seaweedfs_tpu/native/."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "from seaweedfs_tpu_torch.ec import gf\n"
        "from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder\n"
        "from seaweedfs_tpu_torch.storage.needle import Needle\n"
        "from seaweedfs_tpu_torch.storage.store import Store\n"
        "st = Store([sys.argv[1]], index_type='compact')\n"
        "st.add_volume(1)\n"
        "st.write_needle(1, Needle(cookie=1, id=1, data=b'x' * 100))\n"
        "assert st.read_needle(1, 1).data == b'x' * 100\n"
        "st.close()\n"
        "enc = CpuEncoder()\n"
        "assert enc.use_native\n"
        "enc.encode([np.zeros(64, np.uint8)] * gf.DATA_SHARDS)\n"
        "maps = [line.split()[-1] for line in open('/proc/self/maps')\n"
        "        if 'libswtpu_native' in line]\n"
        "print(json.dumps(sorted(set(maps))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    maps = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(maps) == 1, maps
    assert os.path.dirname(maps[0]) == os.path.join(PORT, "_build")


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax_and_no_reference_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if _forbidden(n)]
    assert bad == [], f"{path} imports {bad}"


def test_weedsched_quick_loads_no_jax_no_reference_and_no_tools():
    """`python -m seaweedfs_tpu_torch.tools.weedsched --quick --json`
    exits 0 with the explorer's report, and its process imports no jax,
    nothing of seaweedfs_tpu and nothing of the repo's tools/ package,
    even though the reference's loop and explorer import no package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "seaweedfs_tpu_torch.tools.weedsched", "--quick", "--json"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(proc.stdout)
    assert report["ok"] and report["mode"] == "quick"
    assert {r["name"] for r in report["scenarios"]} >= {
        "raft-sequencer", "shard-replay", "chunk-cache", "frame-channel",
        "singleflight", "autopilot", "pending-leak", "gen-fence"}
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "seaweedfs_tpu_torch.master.election" in imported
    assert [m for m in imported
            if _forbidden(m) or m.split(".")[0] == "tools"] == []
