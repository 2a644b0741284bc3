"""fs.* and collection.* admin shell commands.

Reference: weed/shell/command_fs_ls.go, _cat.go, _du.go, _tree.go, _mv.go,
command_fs_meta_save.go/_load.go (filer metadata backup/restore to a pb
file — here JSON-lines), command_collection_list.go/_delete.go.

A copy of seaweedfs_tpu/shell/fs_commands.py in the PyTorch port.
"""

from __future__ import annotations

import json
import posixpath

from ..security import tls
from ..util import tracing
from .env import CommandEnv


def _filer_url(filer: str, path: str) -> str:
    # the filer HTTP surface is deliberately plaintext even when the
    # master/volume mesh runs mTLS (client-facing, like the reference)
    return f"http://{filer}" + (path if path.startswith("/")
                                else "/" + path)


_PAGE = 1024


async def _list_dir(env: CommandEnv, filer: str, path: str) -> list[dict]:
    """Full directory listing, paginating past the server's per-request
    cap with startFile (fs.meta.save must never silently truncate)."""
    out: list[dict] = []
    start = ""
    while True:
        async with env.http.get(_filer_url(filer, "/__api__/list"),
                                params={"path": path, "startFile": start,
                                        "limit": str(_PAGE)}) as resp:
            page = (await resp.json()).get("entries", [])
        out.extend(page)
        if len(page) < _PAGE:
            return out
        start = posixpath.basename(page[-1]["FullPath"])


def _is_dir(e: dict) -> bool:
    return bool(e.get("IsDirectory"))


def _size(e: dict) -> int:
    return sum(c.get("size", 0) for c in e.get("chunks", []))


async def fs_ls(env: CommandEnv, filer: str, path: str = "/",
                long_format: bool = False) -> list[dict] | list[str]:
    entries = await _list_dir(env, filer, path)
    if long_format:
        return [{
            "name": posixpath.basename(e["FullPath"]) +
            ("/" if _is_dir(e) else ""),
            "size": _size(e),
            "mode": e.get("Mode", 0),
            "mtime": e.get("Mtime", 0),
        } for e in entries]
    return [posixpath.basename(e["FullPath"]) + ("/" if _is_dir(e) else "")
            for e in entries]


async def fs_cat(env: CommandEnv, filer: str, path: str) -> bytes:
    async with env.http.get(_filer_url(filer, path)) as resp:
        if resp.status != 200:
            raise RuntimeError(f"cat {path}: http {resp.status}")
        return await resp.read()


async def _walk(env: CommandEnv, filer: str, path: str):
    """Yield (entry, depth) over the whole subtree, depth-first."""
    stack = [(path, 0)]
    while stack:
        cur, depth = stack.pop()
        entries = await _list_dir(env, filer, cur)
        for e in sorted(entries, key=lambda x: x["FullPath"], reverse=True):
            yield e, depth
            if _is_dir(e):
                stack.append((e["FullPath"], depth + 1))


async def fs_du(env: CommandEnv, filer: str, path: str = "/") -> dict:
    files = dirs = size = 0
    async for e, _ in _walk(env, filer, path):
        if _is_dir(e):
            dirs += 1
        else:
            files += 1
            size += _size(e)
    return {"path": path, "files": files, "dirs": dirs, "bytes": size}


async def fs_tree(env: CommandEnv, filer: str, path: str = "/") -> str:
    lines = [path]
    # re-walk with correct ordering for display (small trees only)
    async def rec(cur: str, prefix: str) -> None:
        entries = sorted(await _list_dir(env, filer, cur),
                         key=lambda e: e["FullPath"])
        for i, e in enumerate(entries):
            last = i == len(entries) - 1
            name = posixpath.basename(e["FullPath"])
            lines.append(prefix + ("└── " if last else "├── ") + name
                         + ("/" if _is_dir(e) else ""))
            if _is_dir(e):
                await rec(e["FullPath"],
                          prefix + ("    " if last else "│   "))
    await rec(path, "")
    return "\n".join(lines)


async def fs_mv(env: CommandEnv, filer: str, src: str, dst: str) -> dict:
    async with env.http.post(_filer_url(filer, "/__api__/rename"),
                             params={"from": src, "to": dst}) as resp:
        body = await resp.json()
        if resp.status != 200:
            raise RuntimeError(f"mv: {body.get('error')}")
    return {"moved": src, "to": dst}


async def fs_rm(env: CommandEnv, filer: str, path: str,
                recursive: bool = False) -> dict:
    async with env.http.delete(
            _filer_url(filer, path),
            params={"recursive": "true" if recursive else "false"}) as resp:
        if resp.status not in (204, 404):
            raise RuntimeError(f"rm {path}: http {resp.status} "
                               f"{await resp.text()}")
    return {"removed": path}


async def fs_meta_save(env: CommandEnv, filer: str, path: str,
                       out_file: str) -> dict:
    """Dump the subtree's metadata to JSON-lines
    (fs.meta.save, command_fs_meta_save.go)."""
    # streamed in batches: the shell shares its loop with the env's
    # http session (writes must not stall it), and a multi-million
    # entry namespace must not accumulate in RAM
    n = 0
    f = await tracing.run_in_executor(open, out_file, "w")
    try:
        batch: list[str] = []
        async for e, _ in _walk(env, filer, path):
            batch.append(json.dumps(e) + "\n")
            n += 1
            if len(batch) >= 512:
                lines, batch = batch, []
                await tracing.run_in_executor(f.writelines, lines)
        if batch:
            await tracing.run_in_executor(f.writelines, batch)
    finally:
        await tracing.run_in_executor(f.close)
    return {"saved": n, "file": out_file}


async def fs_meta_load(env: CommandEnv, filer: str, in_file: str) -> dict:
    """Recreate entries from a fs.meta.save dump. Chunks keep their fids:
    restoring onto the same cluster restores files, onto a fresh cluster
    restores the namespace (command_fs_meta_load.go semantics)."""
    n = 0
    failures: list[str] = []
    # bounded batches of lines per executor round-trip: dumps can be
    # namespace-sized, so neither whole-file buffering nor on-loop reads
    f = await tracing.run_in_executor(open, in_file)
    try:
        while True:
            lines = await tracing.run_in_executor(f.readlines, 1 << 16)
            if not lines:
                break
            for line in lines:
                if not line.strip():
                    continue
                e = json.loads(line)
                async with env.http.post(
                        _filer_url(filer, "/__api__/entry"),
                        json=e) as resp:
                    if resp.status == 200:
                        n += 1
                    else:
                        # a partial restore must never look like success
                        failures.append(
                            f"{e.get('FullPath')}: http {resp.status} "
                            f"{(await resp.text())[:120]}")
    finally:
        await tracing.run_in_executor(f.close)
    out = {"loaded": n, "failed": len(failures), "file": in_file}
    if failures:
        out["errors"] = failures[:10]
    return out


async def fs_meta_cat(env: CommandEnv, filer: str, path: str) -> dict:
    """Full stored metadata of one entry (command_fs_meta_cat.go)."""
    async with env.http.get(_filer_url(filer, "/__api__/lookup"),
                            params={"path": path}) as resp:
        body = await resp.json()
        if resp.status != 200:
            raise ValueError(f"{path}: {body.get('error', 'lookup failed')}")
        return body


def _api_to_entry_dict(e: dict) -> dict:
    """FilerServer._entry_json wire shape -> filer Entry.to_dict shape
    (what EventNotification payloads carry, pb/filer.proto analog)."""
    return {
        "full_path": e["FullPath"],
        "attr": {
            "mtime": e.get("Mtime", 0), "crtime": e.get("Crtime", 0),
            "mode": e.get("Mode", 0o660),
            "uid": e.get("Uid", 0), "gid": e.get("Gid", 0),
            "mime": e.get("Mime", ""),
            "replication": e.get("Replication", ""),
            "collection": e.get("Collection", ""),
            "ttl_sec": e.get("TtlSec", 0),
        },
        "chunks": e.get("chunks", []),
        "extended": e.get("extended", {}),
    }


async def fs_meta_notify(env: CommandEnv, filer: str, path: str,
                         queue) -> dict:
    """Re-publish create events for a whole subtree into a notification
    queue, so a replicator can be primed with data that predates the
    queue (command_fs_meta_notify.go). Events go through the same
    event_of producer the live filer listeners use, so the wire shape
    cannot drift from what Replicator consumes."""
    from ..filer.entry import Entry
    from ..notification.queues import event_of

    dirs = files = 0
    async for e, _ in _walk(env, filer, path):
        entry = Entry.from_dict(_api_to_entry_dict(e))
        queue.send_message(e["FullPath"],
                           event_of(None, entry, delete_chunks=False))
        if _is_dir(e):
            dirs += 1
        else:
            files += 1
    return {"notified_dirs": dirs, "notified_files": files}


async def collection_list(env: CommandEnv) -> list[str]:
    body = await env.master_get("/vol/volumes")
    cols = set()
    for node in body.get("nodes", []):
        for m in node.get("volumes", []) + node.get("ecShards", []):
            cols.add(m.get("collection", ""))
    return sorted(cols)


async def collection_delete(env: CommandEnv, name: str) -> dict:
    async with env.http.post(tls.url(env.master_url, "/col/delete"),
                             params={"collection": name}) as resp:
        return await resp.json()
