"""Source-cluster data access for replication.

Reference: weed/replication/source/filer_source.go — resolve a chunk fid
to a volume-server URL on the SOURCE cluster and read its bytes.

A copy of seaweedfs_tpu/replication/source.py in the PyTorch port.
"""

from __future__ import annotations

from ..util.client import WeedClient


class FilerSource:
    def __init__(self, master_url: str, directory: str = "/"):
        self.master_url = master_url
        self.dir = directory.rstrip("/") or "/"
        self._client: WeedClient | None = None

    async def __aenter__(self) -> "FilerSource":
        self._client = WeedClient(self.master_url)
        await self._client.__aenter__()
        return self

    async def __aexit__(self, *exc) -> None:
        if self._client:
            await self._client.__aexit__()

    @property
    def client(self) -> WeedClient:
        assert self._client is not None, "use 'async with FilerSource(...)'"
        return self._client

    async def read_part(self, fid: str, offset: int = 0,
                        size: int = -1) -> bytes:
        """source/filer_source.go ReadPart: fetch chunk bytes by fid."""
        return await self.client.read(fid, offset=offset, size=size)
