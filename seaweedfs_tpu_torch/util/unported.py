"""The answer of a route that reaches a module the port does not have yet.

Such a handler fails its lazy import with an ImportError that names the
seaweedfs_tpu_torch module; `middleware` answers 500 with that message
instead of aiohttp's bare 500. The volume server and the master install
it (the filer route cache of util/client.py and a filer shard-map change
need filer/, which is not in the port yet). Nothing of the JAX package
has it: it is the port's own.
"""

from __future__ import annotations

from aiohttp import web

# this package's name, which the ImportError of a module not ported yet
# carries
_PORT = __name__.split(".")[0]


@web.middleware
async def middleware(req: web.Request, handler):
    try:
        return await handler(req)
    except ImportError as e:
        if _PORT not in str(e):
            raise
        return web.json_response(
            {"error": f"not ported yet: {e}"}, status=500)
