"""Shell command dispatch: parse 'ec.encode -collection x' style lines.

Reference: weed/shell/commands.go registry + shell_liner.go REPL.

A copy of seaweedfs_tpu/shell/runner.py in the PyTorch port.
"""

from __future__ import annotations

import json
import posixpath
import shlex

from . import ec_commands as ec
from . import fs_commands as fs
from . import volume_commands as vc
from .env import CommandEnv

HELP = """commands:
  ec.encode    [-collection c] [-volumeId n] [-fullPercent 95]
  ec.rebuild   [-collection c] [-force]
  ec.verify    [-collection c] [-volumeId n] [-windowMB 4]
  ec.decode    [-collection c] [-volumeId n]
  ec.balance   [-collection c] [-force]
  volume.vacuum          [-garbageThreshold 0.3] [-collection c]
  volume.fix.replication [-force]
  volume.balance         [-force] [-collection ALL_COLLECTIONS|EACH_COLLECTION|name] [-dataCenter dc]
  volume.move   -volumeId n -source host:port -target host:port
  volume.copy   -volumeId n -source host:port -target host:port
  volume.mount   -volumeId n -node host:port [-collection c]
  volume.unmount -volumeId n -node host:port
  volume.delete  -volumeId n -node host:port [-collection c]
  volume.tier.upload   -volumeId n [-backend s3.default] [-keepLocal]
  volume.tier.download -volumeId n
  volume.list
  collection.list
  collection.delete -collection c
  fs.cd   -filer host:port [-path /dir]   (sets session default filer+dir)
  fs.pwd
  fs.ls   [-filer host:port] [-path /dir] [-l]
  fs.cat  [-filer host:port] -path /f
  fs.du   [-filer host:port] [-path /dir]
  fs.tree [-filer host:port] [-path /dir]
  fs.mv   [-filer host:port] -from /a -to /b
  fs.rm   [-filer host:port] -path /f [-recursive]
  fs.meta.cat    [-filer host:port] -path /f
  fs.meta.save   [-filer host:port] [-path /] [-o meta.jsonl]
  fs.meta.load   [-filer host:port] [-i meta.jsonl]
  fs.meta.notify [-filer host:port] [-path /] -notify file:<p>|sqlite:<p>|log
fs.* also accept the path positionally (fs.ls /dir) and resolve relative
paths against the fs.cd working directory.
"""


def _resolve_path(env: CommandEnv, p: str | None) -> str:
    """Resolve an fs.* path against the session working directory
    (fs.cd semantics, shell/command_fs_cd.go)."""
    if not p:
        return env.wd
    if not p.startswith("/"):
        p = posixpath.join(env.wd, p)
    return posixpath.normpath(p)


# flags that never take a free-form value: a following bare token is the
# positional path, not the flag's value (`fs.rm -recursive /f` must not
# parse as recursive="/f"); an explicit true/false is still honored
_BOOL_FLAGS = {"force", "keepLocal", "l", "recursive"}


def _flags(tokens: list[str]) -> tuple[dict[str, str], list[str]]:
    """Returns (flags, positionals). A bare token not consumed as a flag
    value is positional — the reference's fs.* commands take their path
    that way (`fs.ls /dir`, commandEnv.parseUrl)."""
    out = {}
    pos = []
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok.startswith("-"):
            key = tok.lstrip("-")
            nxt = tokens[i + 1] if i + 1 < len(tokens) else "-"
            if "=" in tok:  # -fullPercent=95 (reference admin-script style)
                key, _, val = key.partition("=")
                out[key] = val
                i += 1
            elif key in _BOOL_FLAGS:
                if nxt in ("true", "false"):
                    out[key] = nxt
                    i += 2
                else:
                    out[key] = "true"
                    i += 1
            elif not nxt.startswith("-"):
                out[key] = nxt
                i += 2
            else:
                out[key] = "true"
                i += 1
        else:
            pos.append(tok)
            i += 1
    return out, pos


async def run_command(master_url: str, line: str) -> object:
    """Interactive/CLI entry: own session + printed result."""
    async with CommandEnv(master_url) as env:
        res = await dispatch(env, line)
    if res is not None:
        print(json.dumps(res, indent=2, default=str))
    return res


async def dispatch(env: CommandEnv, line: str) -> object:
    """Parse + run one shell command line against an existing env (no
    result printing) — the master's maintenance loop drives admin scripts
    through this (master_server.go:186-250 startAdminScripts analog)."""
    tokens = shlex.split(line)
    if not tokens:
        return None
    cmd, (flags, positional) = tokens[0], _flags(tokens[1:])
    if positional and cmd.startswith("fs.") and "path" not in flags:
        # reference style: `fs.ls /dir`, `fs.cd /x` (fs.mv keeps its
        # explicit -from/-to; a positional never silently becomes one)
        flags["path"] = positional[0]
    if cmd == "ec.encode":
        vids = [int(flags["volumeId"])] if "volumeId" in flags else None
        res = await ec.ec_encode(
            env, collection=flags.get("collection", ""), vids=vids,
            fullness=float(flags.get("fullPercent", 95)) / 100)
    elif cmd == "ec.verify":
        vid_s = flags.get("volumeId")
        res = await ec.ec_verify(
            env, collection=flags.get("collection", ""),
            volume_id=int(vid_s) if vid_s else None,
            window_mb=int(flags.get("windowMB", 4)))
    elif cmd == "ec.rebuild":
        res = await ec.ec_rebuild(
            env, collection=flags.get("collection", ""),
            apply_changes=flags.get("force") == "true")
    elif cmd == "ec.decode":
        vids = [int(flags["volumeId"])] if "volumeId" in flags else None
        res = await ec.ec_decode(
            env, collection=flags.get("collection", ""), vids=vids)
    elif cmd == "ec.balance":
        res = await ec.ec_balance(
            env, collection=flags.get("collection", ""),
            apply_changes=flags.get("force") == "true")
    elif cmd == "volume.vacuum":
        res = await vc.volume_vacuum(
            env, float(flags.get("garbageThreshold", 0.3)),
            flags.get("collection"))
    elif cmd == "volume.fix.replication":
        res = await vc.volume_fix_replication(
            env, apply_changes=flags.get("force") == "true")
    elif cmd == "volume.balance":
        res = await vc.volume_balance(
            env, apply_changes=flags.get("force") == "true",
            collection=flags.get("collection", "EACH_COLLECTION"),
            data_center=flags.get("dataCenter", ""))
    elif cmd == "volume.move":
        await vc.volume_move(env, int(flags["volumeId"]),
                             flags.get("collection", ""),
                             flags["source"], flags["target"])
        res = {"moved": flags["volumeId"]}
    elif cmd == "volume.copy":
        await vc.volume_copy(env, int(flags["volumeId"]),
                             flags.get("collection", ""),
                             flags["source"], flags["target"])
        res = {"copied": flags["volumeId"], "to": flags["target"]}
    elif cmd == "volume.mount":
        res = await vc.volume_mount(env, int(flags["volumeId"]),
                                    flags["node"],
                                    flags.get("collection", ""))
    elif cmd == "volume.unmount":
        res = await vc.volume_unmount(env, int(flags["volumeId"]),
                                      flags["node"])
    elif cmd == "volume.delete":
        res = await vc.volume_delete(env, int(flags["volumeId"]),
                                     flags["node"],
                                     flags.get("collection", ""))
    elif cmd == "volume.tier.upload":
        res = await vc.volume_tier_upload(
            env, int(flags["volumeId"]),
            backend=flags.get("backend", "s3.default"),
            keep_local=flags.get("keepLocal") == "true")
    elif cmd == "volume.tier.download":
        res = await vc.volume_tier_download(env, int(flags["volumeId"]))
    elif cmd == "volume.list":
        res = await env.list_nodes()
    elif cmd == "collection.list":
        res = await fs.collection_list(env)
    elif cmd == "collection.delete":
        res = await fs.collection_delete(env, flags["collection"])
    elif cmd.startswith("fs."):
        filer = flags.get("filer", "") or env.filer
        if cmd == "fs.pwd":
            return {"filer": filer, "cwd": env.wd}
        if not filer:
            raise ValueError(
                "fs.* commands need -filer host:port (or a prior fs.cd)")
        path = _resolve_path(env, flags.get("path"))
        if cmd == "fs.cd":
            if path != "/":
                # validate before committing the session default
                meta = await fs.fs_meta_cat(env, filer, path)
                if not meta.get("IsDirectory"):
                    raise ValueError(f"{path} is not a directory")
            env.filer, env.wd = filer, path
            return {"filer": filer, "cwd": path}
        if cmd == "fs.ls":
            res = await fs.fs_ls(env, filer, path,
                                 long_format=flags.get("l") == "true")
        elif cmd == "fs.cat":
            data = await fs.fs_cat(env, filer, path)
            print(data.decode(errors="replace"))
            return None
        elif cmd == "fs.du":
            res = await fs.fs_du(env, filer, path)
        elif cmd == "fs.tree":
            print(await fs.fs_tree(env, filer, path))
            return None
        elif cmd == "fs.mv":
            res = await fs.fs_mv(env, filer,
                                 _resolve_path(env, flags["from"]),
                                 _resolve_path(env, flags["to"]))
        elif cmd == "fs.rm":
            if "path" not in flags:
                # never let a forgotten -path default to deleting "/"
                raise ValueError("fs.rm requires an explicit -path")
            res = await fs.fs_rm(env, filer,
                                 _resolve_path(env, flags["path"]),
                                 recursive=flags.get(
                                     "recursive") == "true")
        elif cmd == "fs.meta.cat":
            if "path" not in flags:
                raise ValueError("fs.meta.cat requires -path")
            res = await fs.fs_meta_cat(env, filer, path)
        elif cmd == "fs.meta.notify":
            from ..notification.queues import queue_from_spec
            from ..util import tracing
            if "notify" not in flags:
                raise ValueError("fs.meta.notify requires "
                                 "-notify file:<p>|sqlite:<p>|log")
            # FileQueue's ctor makedirs/creates its backing file — off
            # the loop, the shell may be driving live-cluster commands
            queue = await tracing.run_in_executor(
                queue_from_spec, flags["notify"])
            try:
                res = await fs.fs_meta_notify(env, filer, path, queue)
            finally:
                queue.close()
        elif cmd == "fs.meta.save":
            res = await fs.fs_meta_save(env, filer, path,
                                        flags.get("o", "meta.jsonl"))
        elif cmd == "fs.meta.load":
            res = await fs.fs_meta_load(env, filer,
                                        flags.get("i", "meta.jsonl"))
        else:
            raise ValueError(f"unknown command {cmd!r}; try 'help'")
    else:
        raise ValueError(f"unknown command {cmd!r}; try 'help'")
    return res
