"""Shell command environment: master connection + cluster queries.

Reference: weed/shell/commands.go (CommandEnv wraps a wdclient master
connection used by every command).

A copy of seaweedfs_tpu/shell/env.py in the PyTorch port.
"""

from __future__ import annotations

from ..security import tls

import aiohttp


class CommandEnv:
    def __init__(self, master_url: str,
                 session: aiohttp.ClientSession | None = None):
        self.master_url = master_url
        self._session = session
        self._own_session = session is None
        # REPL working-directory state (fs.cd / fs.pwd,
        # shell/command_fs_cd.go + command_fs_pwd.go): fs.* commands
        # default their -filer/-path to these when a session reuses one
        # env across commands
        self.filer = ""
        self.wd = "/"

    async def __aenter__(self) -> "CommandEnv":
        if self._session is None:
            self._session = tls.make_session(
                timeout=aiohttp.ClientTimeout(total=300))
        return self

    async def __aexit__(self, *exc) -> None:
        if self._own_session and self._session:
            await self._session.close()

    @property
    def http(self) -> aiohttp.ClientSession:
        assert self._session is not None, "use 'async with CommandEnv(...)'"
        return self._session

    async def master_get(self, path: str, **params) -> dict:
        async with self.http.get(tls.url(self.master_url, f"{path}"),
                                 params=params) as resp:
            return await resp.json()

    async def node_post(self, url: str, path: str, **params) -> dict:
        async with self.http.post(tls.url(url, f"{path}"),
                                  params=params) as resp:
            body = await resp.json()
            if resp.status != 200:
                raise RuntimeError(f"POST {url}{path}: {body}")
            return body

    async def list_nodes(self) -> list[dict]:
        return (await self.master_get("/vol/volumes"))["nodes"]
