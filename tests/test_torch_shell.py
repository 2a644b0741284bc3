"""JWT write-token enforcement + shell command dispatch.

The cases of tests/test_security_and_shell.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
"""

import time

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.security import jwt as J


def test_jwt_roundtrip():
    tok = J.gen_jwt("secret", "3,01abc", expires_seconds=60)
    claims = J.decode_jwt("secret", tok)
    assert claims["fid"] == "3,01abc"
    J.check_write_jwt("secret", tok, "3,01abc")
    with pytest.raises(J.JwtError):
        J.check_write_jwt("secret", tok, "4,ffff")
    with pytest.raises(J.JwtError):
        J.decode_jwt("wrongkey", tok)
    expired = J.gen_jwt("secret", "3,01abc", expires_seconds=-5)
    with pytest.raises(J.JwtError):
        J.decode_jwt("secret", expired)


def test_cluster_enforces_jwt(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            # flip on jwt after boot (both sides share the key)
            c.master.jwt_key = "s3cret"
            for vs in c.servers:
                vs.jwt_key = "s3cret"
            a = await c.assign()
            assert "auth" in a
            # write without token -> 401
            st, body_ = await c.put(a["fid"], a["url"], b"x")
            assert st == 401, body_
            # write with token -> 201
            async with c.http.post(
                    f"http://{a['url']}/{a['fid']}", data=b"x",
                    headers={"Authorization": f"Bearer {a['auth']}"}) as r:
                assert r.status == 201
            # reads stay open (read jwt optional in reference too)
            st, data = await c.get(a["fid"], a["url"])
            assert st == 200 and data == b"x"
            # delete without token -> 401
            assert await c.delete(a["fid"], a["url"]) == 401
            # batch delete must not bypass the write-token guard
            async with c.http.post(
                    f"http://{a['url']}/admin/batch_delete",
                    json={"fileIds": [a["fid"]]}) as r:
                assert r.status == 200
                rows = (await r.json())["results"]
            assert rows[0]["status"] == 401
            st, _ = await c.get(a["fid"], a["url"])
            assert st == 200  # still there
            # with a per-fid token the batch tombstones it
            async with c.http.post(
                    f"http://{a['url']}/admin/batch_delete",
                    json={"fileIds": [a["fid"]],
                          "tokens": {a["fid"]: a["auth"]}}) as r:
                rows = (await r.json())["results"]
            assert rows[0]["status"] == 202
            st, _ = await c.get(a["fid"], a["url"])
            assert st == 404
    run(body())


def test_shell_runner_dispatch(tmp_path, capsys):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            await c.put(a["fid"], a["url"], b"listed")
            await c.heartbeat_all()
            from seaweedfs_tpu_torch.shell.runner import run_command
            res = await run_command(c.master.url, "volume.list")
            assert res and res[0]["volumes"]
            with pytest.raises(ValueError):
                await run_command(c.master.url, "bogus.command")
    run(body())


def test_cli_shell_one_command_and_the_prompt(tmp_path):
    """`python -m seaweedfs_tpu_torch.cli shell`: `-c` prints one
    command's JSON result, and the prompt reads commands from stdin until
    `exit`, printing `help` and each result."""
    import asyncio
    import json
    import os
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    async def shell(master: str, *args: str, stdin: bytes = b"") -> str:
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "seaweedfs_tpu_torch.cli", "shell",
            "-master", master, "-timeline.interval", "0", *args,
            cwd=repo, env=env, stdin=asyncio.subprocess.PIPE,
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(proc.communicate(stdin), 120)
        assert proc.returncode == 0, err.decode()[-2000:]
        return out.decode()

    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign(collection="pics")
            await c.put(a["fid"], a["url"], b"listed")
            await c.heartbeat_all()
            out = await shell(c.master.url, "-c", "collection.list")
            assert json.loads(out) == ["pics"]
            out = await shell(c.master.url,
                              stdin=b"help\ncollection.list\nexit\n")
            assert "ec.encode" in out and '"pics"' in out
    run(body())
