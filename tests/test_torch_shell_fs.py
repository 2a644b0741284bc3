"""fs.*/collection.* shell commands, FileSequencer, status UIs.

The cases of tests/test_shell_fs.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import os

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.master.sequence import FileSequencer
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell import fs_commands as fs


def test_file_sequencer_survives_restart(tmp_path):
    p = str(tmp_path / "seq")
    s = FileSequencer(p, step=10)
    ids = [s.next_file_id() for _ in range(25)]
    assert ids == list(range(1, 26))
    # restart: resumes at/after the checkpoint, never reissues
    s2 = FileSequencer(p, step=10)
    nxt = s2.next_file_id()
    assert nxt > max(ids)
    # set_max from heartbeats pushes forward, not back
    s2.set_max(1000)
    assert s2.next_file_id() == 1001
    s3 = FileSequencer(p, step=10)
    assert s3.next_file_id() > 1001


def test_fs_commands_and_ui(tmp_path):
    async def body():
        c = Cluster(str(tmp_path))
        c.with_filer = True
        async with c:
            furl = c.filer.url

            async def fput(path, data):
                async with c.http.post(
                        f"http://{furl}{path}", data=data) as resp:
                    assert resp.status in (200, 201), await resp.text()

            await fput("/docs/a.txt", b"alpha")
            await fput("/docs/sub/b.txt", b"b" * 1000)
            await fput("/top.txt", b"t")

            async with CommandEnv(c.master.url) as env:
                names = await fs.fs_ls(env, furl, "/docs")
                assert set(names) == {"a.txt", "sub/"}
                long = await fs.fs_ls(env, furl, "/docs", long_format=True)
                assert any(e["name"] == "a.txt" and e["size"] == 5
                           for e in long)

                assert await fs.fs_cat(env, furl, "/docs/a.txt") == b"alpha"

                du = await fs.fs_du(env, furl, "/docs")
                assert du["files"] == 2 and du["bytes"] == 1005
                assert du["dirs"] == 1

                tree = await fs.fs_tree(env, furl, "/docs")
                assert "a.txt" in tree and "sub/" in tree

                await fs.fs_mv(env, furl, "/docs/a.txt", "/docs/a2.txt")
                assert await fs.fs_cat(env, furl, "/docs/a2.txt") == b"alpha"

                # meta save / restore round trip
                meta = str(tmp_path / "meta.jsonl")
                saved = await fs.fs_meta_save(env, furl, "/docs", meta)
                assert saved["saved"] >= 3  # a2, sub, sub/b
                await fs.fs_rm(env, furl, "/docs", recursive=True)
                assert await fs.fs_ls(env, furl, "/docs") == []
                loaded = await fs.fs_meta_load(env, furl, meta)
                assert loaded["loaded"] >= 3
                # same cluster: chunks still exist, so content is restored
                assert await fs.fs_cat(env, furl, "/docs/a2.txt") == b"alpha"

                cols = await fs.collection_list(env)
                assert "" in cols

            # status UIs render
            async with c.http.get(
                    f"http://{c.master.url}/ui") as resp:
                page = await resp.text()
                assert resp.status == 200
                assert "seaweedfs_tpu master" in page
            async with c.http.get(
                    f"http://{c.servers[0].url}/ui") as resp:
                page = await resp.text()
                assert resp.status == 200 and "volume server" in page

    run(body())
