"""The port CLI's subcommands that need no filer: `upload`, `download`,
`benchmark`, `scaffold` and `version`, held to the JAX package's CLI on
the same argv.

`scaffold` prints the same bytes for every -config; `version` the same
line with the package's name. `upload`, `download` and `benchmark` run as
subprocesses of both CLIs against one port master and volume server (in a
thread of the test process): upload's JSON is equal with the fids masked
(each upload gets its own), download writes the same bytes and line
(for a plain needle and a chunk manifest),
and benchmark prints the same lines with every measured number masked.
"""

from __future__ import annotations

import asyncio
import json
import os
import re
import subprocess
import sys
import threading

import pytest

from test_torch_cluster_util import Cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"port": "seaweedfs_tpu_torch.cli", "ref": "seaweedfs_tpu.cli"}


@pytest.mark.parametrize("config", ["security", "master", "filer",
                                    "notification", "replication"])
def test_scaffold_equals_the_reference(config, capsys):
    from seaweedfs_tpu import cli as ref_cli
    from seaweedfs_tpu_torch import cli as port_cli
    out = {}
    for name, mod in (("port", port_cli), ("ref", ref_cli)):
        mod.main(["scaffold", "-config", config])
        out[name] = capsys.readouterr().out
    assert out["port"] == out["ref"] and out["port"].startswith("#")


def test_version_names_the_package(capsys):
    from seaweedfs_tpu import cli as ref_cli
    from seaweedfs_tpu_torch import cli as port_cli
    port_cli.main(["version"])
    port = capsys.readouterr().out
    ref_cli.main(["version"])
    ref = capsys.readouterr().out
    assert port == ref.replace("seaweedfs_tpu ", "seaweedfs_tpu_torch ")
    assert port.startswith("seaweedfs_tpu_torch ")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """A port master and one port volume server on a loop of their own."""
    tmp = str(tmp_path_factory.mktemp("clients"))
    ready, stop = threading.Event(), None
    box: dict = {}

    async def serve():
        nonlocal stop
        stop = asyncio.Event()
        async with Cluster(tmp, n_servers=1) as c:
            box["master"] = c.master.url
            ready.set()
            await stop.wait()

    loop = asyncio.new_event_loop()
    t = threading.Thread(target=loop.run_until_complete, args=(serve(),),
                         daemon=True)
    t.start()
    assert ready.wait(60)
    yield box["master"], tmp
    loop.call_soon_threadsafe(stop.set)
    t.join(30)


def _run(pkg: str, *args: str, cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "-m", CLIS[pkg], *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, (pkg, args, proc.stderr[-2000:])
    return proc


def test_upload_and_download_equal_the_reference(cluster, tmp_path):
    master, _ = cluster
    src = tmp_path / "src"
    src.mkdir()
    rng = __import__("random").Random(3)
    for name, n in (("a.txt", 10), ("b.bin", 70_000), ("big.bin", 2_600_000)):
        (src / name).write_bytes(rng.randbytes(n))
    uploads = {}
    for pkg in CLIS:
        proc = _run(pkg, "upload", "-master", master, "-maxMB", "1",
                    str(src / "a.txt"), str(src / "b.bin"),
                    str(src / "big.bin"), cwd=str(tmp_path))
        uploads[pkg] = json.loads(proc.stdout)
    masked = {pkg: [{k: ("masked" if k in ("fid", "fileUrl") else v)
                     for k, v in row.items()} for row in rows]
              for pkg, rows in uploads.items()}
    assert masked["port"] == masked["ref"]
    assert [r.get("chunks") for r in masked["port"]] == [None, None, 3]
    for row in (uploads["port"][0], uploads["port"][2]):
        outs = {}
        for pkg in CLIS:
            out = tmp_path / f"{pkg}-{row['fileName']}"
            proc = _run(pkg, "download", "-master", master, row["fid"],
                        "-o", str(out), cwd=str(tmp_path))
            outs[pkg] = (proc.stdout.replace(str(out), "OUT"),
                         out.read_bytes())
        assert outs["port"] == outs["ref"]
        assert outs["port"][1] == (src / row["fileName"]).read_bytes()


def test_benchmark_prints_the_reference_lines(cluster, tmp_path):
    master, _ = cluster
    lines = {}
    for pkg in CLIS:
        proc = _run(pkg, "benchmark", "-master", master, "-n", "64",
                    "-size", "512", "-c", "4", "-collection", f"bm{pkg}",
                    "-deletePercent", "10", cwd=str(tmp_path))
        lines[pkg] = re.sub(r"\d+(\.\d+)?", "N", proc.stdout)
    assert lines["port"] == lines["ref"]
    assert lines["port"].startswith("write: N req/s")
