"""Shell commands added for full command_*.go registry parity: fs.cd /
fs.pwd session state, fs.meta.cat, fs.meta.notify, and the volume
mount/unmount/copy/delete admin commands.

The cases of tests/test_shell_extras.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers (the filer among them)
and its own registries.
"""

from __future__ import annotations

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.filer.entry import Entry
from seaweedfs_tpu_torch.notification.queues import FileQueue
from seaweedfs_tpu_torch.shell.env import CommandEnv
from seaweedfs_tpu_torch.shell.runner import dispatch


async def _fs_commands(c, furl: str, tmp_path) -> None:
    async def fput(path, data):
        async with c.http.post(
                f"http://{furl}{path}", data=data) as resp:
            assert resp.status in (200, 201), await resp.text()

    await fput("/docs/a.txt", b"alpha")
    await fput("/docs/sub/b.txt", b"beta")

    async with CommandEnv(c.master.url) as env:
        # fs.* before any fs.cd and without -filer must not
        # guess a server
        with pytest.raises(ValueError, match="-filer"):
            await dispatch(env, "fs.ls")

        res = await dispatch(env,
                             f"fs.cd -filer {furl} -path /docs")
        assert res == {"filer": furl, "cwd": "/docs"}
        assert (await dispatch(env, "fs.pwd"))["cwd"] == "/docs"

        # session defaults: no -filer, relative -path
        names = await dispatch(env, "fs.ls")
        assert set(names) == {"a.txt", "sub/"}
        meta = await dispatch(env, "fs.meta.cat -path a.txt")
        assert meta["FullPath"] == "/docs/a.txt"
        assert meta["chunks"] and not meta["IsDirectory"]

        # relative cd + normalisation, reference positional style
        res = await dispatch(env, "fs.cd sub")
        assert res["cwd"] == "/docs/sub"
        assert set(await dispatch(env, "fs.ls /docs")) == \
            {"a.txt", "sub/"}
        meta = await dispatch(env, "fs.meta.cat -path ../a.txt")
        assert meta["FullPath"] == "/docs/a.txt"

        # cd to a file is rejected and state is unchanged
        with pytest.raises(ValueError, match="not a directory"):
            await dispatch(env, "fs.cd -path b.txt")
        assert (await dispatch(env, "fs.pwd"))["cwd"] == "/docs/sub"

        # fs.meta.notify primes a queue with create events the
        # replication pipeline can parse
        qpath = str(tmp_path / "notify.q")
        res = await dispatch(
            env, f"fs.meta.notify -path / -notify file:{qpath}")
        assert res["notified_files"] == 2
        assert res["notified_dirs"] >= 2  # /docs, /docs/sub
        msgs, _ = FileQueue(qpath).read_from(0)
        paths = set()
        for m in msgs:
            e = Entry.from_dict(m["event"]["new_entry"])
            assert m["event"]["old_entry"] is None
            paths.add(e.full_path)
        assert {"/docs/a.txt", "/docs/sub/b.txt"} <= paths
        with pytest.raises(ValueError, match="-notify"):
            await dispatch(env, "fs.meta.notify -path /")


def test_fs_cd_pwd_meta_cat_notify(tmp_path):
    async def body():
        c = Cluster(str(tmp_path))
        c.with_filer = True
        async with c:
            await _fs_commands(c, c.filer.url, tmp_path)

    run(body())


def test_volume_mount_unmount_copy_delete(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            a = await c.assign()
            vid = int(a["fid"].split(",")[0])
            st, _ = await c.put(a["fid"], a["url"], b"payload")
            assert st == 201
            src = a["url"]
            dst = next(s.url for s in c.servers if s.url != src)

            async with CommandEnv(c.master.url) as env:
                await dispatch(
                    env, f"volume.copy -volumeId {vid} "
                         f"-source {src} -target {dst}")
                st, body_ = await c.get(a["fid"], dst)
                assert (st, body_) == (200, b"payload")

                async def get_local(url):
                    # no redirects: a server without the volume must not
                    # silently answer via its replica
                    async with c.http.get(f"http://{url}/{a['fid']}",
                                          allow_redirects=False) as resp:
                        return resp.status, await resp.read()

                await dispatch(env,
                               f"volume.unmount -volumeId {vid} -node {dst}")
                st, _ = await get_local(dst)
                assert st != 200

                await dispatch(env,
                               f"volume.mount -volumeId {vid} -node {dst}")
                st, body_ = await get_local(dst)
                assert (st, body_) == (200, b"payload")

                # unmount THEN delete: the files must still be destroyed
                # (a silently-ok no-op would resurrect the volume on the
                # next mount — the volume_move hazard, user-reachable)
                await dispatch(env,
                               f"volume.unmount -volumeId {vid} -node {dst}")
                await dispatch(env,
                               f"volume.delete -volumeId {vid} -node {dst}")
                with pytest.raises(RuntimeError, match="not on disk"):
                    await dispatch(
                        env, f"volume.mount -volumeId {vid} -node {dst}")
                # deleting what is already gone reports failure, not ok
                with pytest.raises(RuntimeError, match="not found"):
                    await dispatch(
                        env, f"volume.delete -volumeId {vid} -node {dst}")
                # the copy source is untouched
                st, body_ = await get_local(src)
                assert (st, body_) == (200, b"payload")

    run(body())


def test_volume_mount_collection_volume(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign(collection="pics")
            vid = int(a["fid"].split(",")[0])
            st, _ = await c.put(a["fid"], a["url"], b"pic-bytes")
            assert st == 201
            node = a["url"]
            async with CommandEnv(c.master.url) as env:
                await dispatch(env,
                               f"volume.unmount -volumeId {vid} -node {node}")
                # without the collection the file name cannot resolve
                with pytest.raises(RuntimeError, match="not on disk"):
                    await dispatch(
                        env, f"volume.mount -volumeId {vid} -node {node}")
                await dispatch(env, f"volume.mount -volumeId {vid} "
                                    f"-node {node} -collection pics")
                async with c.http.get(f"http://{node}/{a['fid']}",
                                      allow_redirects=False) as resp:
                    assert resp.status == 200
                    assert await resp.read() == b"pic-bytes"

    run(body())
