"""Volume admin workflows: volume.vacuum / volume.fix.replication /
volume.balance / volume.move.

Reference: weed/topology/topology_vacuum.go:16-120 (check -> compact ->
commit across replicas), shell/command_volume_fix_replication.go
(re-replicate under-replicated volumes rack-aware), command_volume_balance.go
(even out volume counts), command_volume_move.go.

A copy of seaweedfs_tpu/shell/volume_commands.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio

from ..storage.super_block import ReplicaPlacement
from .env import CommandEnv


async def volume_vacuum(env: CommandEnv, garbage_threshold: float = 0.3,
                        collection: str | None = None) -> list[dict]:
    """check -> compact -> commit on every replica of dirty volumes."""
    results = []
    nodes = await env.list_nodes()
    # vid -> [(url, msg)]
    vols: dict[int, list[tuple[str, dict]]] = {}
    for n in nodes:
        for m in n["volumes"]:
            if collection is not None and m["collection"] != collection:
                continue
            vols.setdefault(m["id"], []).append((n["url"], m))
    for vid, holders in sorted(vols.items()):
        checks = await asyncio.gather(*(
            env.node_post(url, "/admin/vacuum/check", volume=str(vid))
            for url, _ in holders), return_exceptions=True)
        ratios = [c.get("garbage_ratio", 0.0) for c in checks
                  if isinstance(c, dict)]
        if not ratios or max(ratios) < garbage_threshold:
            continue
        try:
            await asyncio.gather(*(
                env.node_post(url, "/admin/vacuum/compact", volume=str(vid))
                for url, _ in holders))
            await asyncio.gather(*(
                env.node_post(url, "/admin/vacuum/commit", volume=str(vid))
                for url, _ in holders))
            results.append({"volume": vid, "garbage": max(ratios),
                            "vacuumed": True})
        except RuntimeError as e:
            await asyncio.gather(*(
                env.node_post(url, "/admin/vacuum/cleanup", volume=str(vid))
                for url, _ in holders), return_exceptions=True)
            results.append({"volume": vid, "error": str(e)})
    return results


async def volume_fix_replication(env: CommandEnv,
                                 apply_changes: bool = True) -> list[dict]:
    """Re-replicate volumes with fewer live copies than their placement
    demands (command_volume_fix_replication.go)."""
    actions = []
    nodes = await env.list_nodes()
    by_url = {n["url"]: n for n in nodes}
    vols: dict[int, list[tuple[str, dict]]] = {}
    for n in nodes:
        for m in n["volumes"]:
            vols.setdefault(m["id"], []).append((n["url"], m))
    for vid, holders in sorted(vols.items()):
        msg = holders[0][1]
        rp = ReplicaPlacement.from_byte(msg["replica_placement"])
        want, have = rp.copy_count, len(holders)
        if have >= want:
            continue
        holder_urls = {u for u, _ in holders}
        holder_racks = {(by_url[u]["dataCenter"], by_url[u]["rack"])
                        for u in holder_urls if u in by_url}
        # prefer a rack not already holding a replica, then most free slots
        candidates = sorted(
            (n for n in nodes
             if n["url"] not in holder_urls and n["freeSlots"] > 0),
            key=lambda n: ((n["dataCenter"], n["rack"]) in holder_racks,
                           -n["freeSlots"]))
        if not candidates:
            actions.append({"volume": vid, "error": "no candidate node"})
            continue
        target = candidates[0]["url"]
        actions.append({"volume": vid, "copy_to": target,
                        "from": holders[0][0]})
        if apply_changes:
            await env.node_post(target, "/admin/volume/copy",
                                volume=str(vid),
                                collection=msg["collection"],
                                source=holders[0][0])
    return actions


def plan_balance(nodes: list[dict], volume_size_limit: int,
                 collection: str = "EACH_COLLECTION",
                 data_center: str = "") -> list[dict]:
    """Pure balance planner, the reference's documented algorithm
    (command_volume_balance.go:29-100):

      * volume servers are grouped by TYPE (their max-volume capacity;
        collectVolumeServersByType), optionally filtered by -dataCenter;
        a type with fewer than two nodes is skipped;
      * -collection selects one collection, ALL_COLLECTIONS, or
        EACH_COLLECTION (default: one balancing pass per collection);
      * per scope, WRITABLE volumes (not read-only, under the size
        limit; move candidates ordered by size ascending) are balanced
        first, then READ-ONLY volumes (ordered by id);
      * balanceSelectedVolume: ideal = ceil(selected / nodes); while the
        fullest node is above ideal and the emptiest fits one more,
        move the first candidate the emptiest node does not already
        hold (never co-locating replicas of one volume).

    Operates on a /vol/volumes snapshot; returns the move plan."""
    import math

    by_type: dict[int, list[dict]] = {}
    for n in nodes:
        if data_center and n.get("dataCenter", "") != data_center:
            continue
        by_type.setdefault(n.get("maxVolumes", 0), []).append(
            {"url": n["url"],
             "volumes": {m["id"]: m for m in n["volumes"]},
             "selected": {}})
    moves: list[dict] = []

    def balance_selected(group: list[dict], order_key) -> None:
        total = sum(len(n["selected"]) for n in group)
        ideal = math.ceil(total / len(group))
        while True:
            group.sort(key=lambda n: len(n["selected"]))
            empty, full = group[0], group[-1]
            if not (len(full["selected"]) > ideal
                    and len(empty["selected"]) + 1 <= ideal):
                return
            candidates = sorted(full["selected"].values(), key=order_key)
            for m in candidates:
                if m["id"] not in empty["volumes"]:
                    moves.append({"volume": m["id"],
                                  "collection": m["collection"],
                                  "from": full["url"],
                                  "to": empty["url"]})
                    del full["selected"][m["id"]]
                    del full["volumes"][m["id"]]
                    empty["selected"][m["id"]] = m
                    empty["volumes"][m["id"]] = m
                    break
            else:
                return  # every candidate already has a copy on `empty`

    for group in by_type.values():
        if len(group) < 2:
            continue
        if collection == "EACH_COLLECTION":
            scopes = sorted({m["collection"] for n in group
                             for m in n["volumes"].values()})
        elif collection == "ALL_COLLECTIONS":
            scopes = [None]
        else:
            scopes = [collection]
        for scope in scopes:
            for sel, order_key in (
                    (lambda m: not m.get("read_only")
                     and m.get("size", 0) < volume_size_limit,
                     lambda m: m.get("size", 0)),
                    (lambda m: m.get("read_only")
                     or m.get("size", 0) >= volume_size_limit,
                     lambda m: m["id"])):
                for n in group:
                    n["selected"] = {
                        vid: m for vid, m in n["volumes"].items()
                        if (scope is None or m["collection"] == scope)
                        and sel(m)}
                balance_selected(group, order_key)
    return moves


async def volume_balance(env: CommandEnv,
                         apply_changes: bool = True,
                         collection: str = "EACH_COLLECTION",
                         data_center: str = "") -> list[dict]:
    """Plan per-type/per-collection balance moves (plan_balance), then
    apply them with volume.move. Planned against one topology snapshot
    (the master registry lags moves until the next heartbeat)."""
    body = await env.master_get("/vol/volumes")
    limit = int(body.get("volumeSizeLimitMB", 30_000)) * 1024 * 1024
    moves = plan_balance(body["nodes"], limit,
                         collection=collection, data_center=data_center)
    if apply_changes:
        for mv in moves:
            await volume_move(env, mv["volume"], mv["collection"],
                              mv["from"], mv["to"])
    return moves


async def volume_copy(env: CommandEnv, vid: int, collection: str,
                      src: str, dst: str) -> dict:
    """Copy a volume to another node, source kept
    (command_volume_copy.go)."""
    return await env.node_post(dst, "/admin/volume/copy", volume=str(vid),
                               collection=collection, source=src)


async def volume_move(env: CommandEnv, vid: int, collection: str,
                      src: str, dst: str) -> None:
    """copy to dst + mount, then unmount + delete on src
    (command_volume_move.go)."""
    await volume_copy(env, vid, collection, src, dst)
    # delete while still mounted so the store destroys the on-disk files
    # (unmount-then-delete would leave .dat/.idx to resurrect on restart)
    await env.node_post(src, "/admin/volume/delete", volume=str(vid))


async def volume_mount(env: CommandEnv, vid: int, node: str,
                       collection: str = "") -> dict:
    """Mount a volume already on the node's disk
    (command_volume_mount.go). The collection names the on-disk file
    (<collection>_<vid>.dat), so it must travel with the request."""
    return await env.node_post(node, "/admin/volume/mount",
                               volume=str(vid), collection=collection)


async def volume_unmount(env: CommandEnv, vid: int, node: str) -> dict:
    """Unmount a volume, keeping its files on disk
    (command_volume_unmount.go)."""
    return await env.node_post(node, "/admin/volume/unmount",
                               volume=str(vid))


async def volume_delete(env: CommandEnv, vid: int, node: str,
                        collection: str = "") -> dict:
    """Delete a volume from a node, destroying its files — including an
    unmounted volume's (command_volume_delete.go)."""
    return await env.node_post(node, "/admin/volume/delete",
                               volume=str(vid), collection=collection)


async def volume_tier_upload(env: CommandEnv, vid: int,
                             backend: str = "s3.default",
                             keep_local: bool = False) -> dict:
    """Ship a volume's .dat to remote storage
    (shell/command_volume_tier_upload.go)."""
    locs = await env.master_get("/dir/lookup", volumeId=str(vid))
    if "locations" not in locs:
        raise ValueError(f"volume {vid} not found")
    out = {}
    for loc in locs["locations"]:
        out[loc["url"]] = await env.node_post(
            loc["url"], "/admin/tier/upload", volume=str(vid),
            backend=backend, keep_local="1" if keep_local else "")
    return out


async def volume_tier_download(env: CommandEnv, vid: int) -> dict:
    """Bring a tiered volume's .dat back to local disk
    (shell/command_volume_tier_download.go)."""
    locs = await env.master_get("/dir/lookup", volumeId=str(vid))
    if "locations" not in locs:
        raise ValueError(f"volume {vid} not found")
    out = {}
    for loc in locs["locations"]:
        out[loc["url"]] = await env.node_post(
            loc["url"], "/admin/tier/download", volume=str(vid))
    return out
