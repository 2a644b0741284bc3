"""glog leveled logging (weed/glog analog) + filer.copy CLI tests.

The cases of tests/test_glog_filer_copy.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import os

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.util import glog


def test_glog_verbosity_gate(capsys):
    glog.init(verbosity=2, logtostderr=True)
    glog.V(2).infof("visible %d", 42)
    glog.V(3).infof("invisible")
    assert not glog.V(3)
    assert glog.V(2)
    err = capsys.readouterr().err
    assert "visible 42" in err
    assert "invisible" not in err
    glog.init(verbosity=0)


def test_glog_severity_files(tmp_path):
    d = str(tmp_path / "logs")
    glog.init(verbosity=0, log_dir=d, logtostderr=False)
    glog.info("hello-info")
    glog.warning("hello-warn")
    glog.error("hello-err")
    files = os.listdir(d)
    assert any("INFO" in f for f in files)
    assert any("WARNING" in f for f in files)
    assert any("ERROR" in f for f in files)
    joined = ""
    for f in files:
        with open(os.path.join(d, f)) as fh:
            joined += fh.read()
    assert "hello-info" in joined and "hello-err" in joined
    glog.init(verbosity=0)  # reset global state for other tests


def test_filer_copy_tree(tmp_path):
    src = tmp_path / "tree"
    (src / "sub").mkdir(parents=True)
    (src / "a.txt").write_bytes(b"alpha")
    (src / "sub" / "b.txt").write_bytes(b"beta" * 1000)
    (src / "sub" / "c.bin").write_bytes(os.urandom(10))

    async def body():
        from seaweedfs_tpu_torch.cli import _run_filer_copy

        class Args:
            paths = [str(src), None]
            concurrency = 4
            include = "*.txt"
            collection = ""
            replication = ""
            ttl = ""

        c = Cluster(str(tmp_path / "cluster"))
        c.with_filer = True
        async with c:
            Args.paths[1] = f"http://{c.filer.url}/dst/"
            await _run_filer_copy(Args)

            async def fget(path):
                async with c.http.get(
                        f"http://{c.filer.url}{path}") as resp:
                    return resp.status, await resp.read()

            st, data = await fget("/dst/tree/a.txt")
            assert st == 200 and data == b"alpha"
            st, data = await fget("/dst/tree/sub/b.txt")
            assert st == 200 and data == b"beta" * 1000
            # .bin filtered out by -include
            st, _ = await fget("/dst/tree/sub/c.bin")
            assert st == 404

    run(body())
