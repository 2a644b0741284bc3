"""Cluster-wide EC workflows: ec.encode / ec.rebuild / ec.balance.

Reference: weed/shell/command_ec_encode.go (pick quiet+full volumes, mark
readonly, generate shards on the source, spread 14 shards round-robin by
free slots, delete the original volume), command_ec_rebuild.go (find
deficient EC volumes, gather inputs on the freest node, regenerate, mount),
command_ec_balance.go:29-100 (dedup -> spread across racks -> within racks;
the help text is the spec), command_ec_common.go (node collection/moves).

A copy of seaweedfs_tpu/shell/ec_commands.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import time

from ..ec import gf
from ..pb import messages as pb
from .env import CommandEnv


async def collect_ec_nodes(env: CommandEnv) -> list[dict]:
    """EC-capable nodes sorted by free slots desc (collectEcNodes,
    command_ec_common.go:181)."""
    nodes = await env.list_nodes()
    nodes.sort(key=lambda n: -n["freeSlots"])
    return nodes


async def collect_volume_ids_for_ec_encode(
        env: CommandEnv, collection: str = "",
        quiet_seconds: float = 3600.0,
        fullness: float = 0.95,
        volume_size_limit: int | None = None) -> list[int]:
    """Quiet + almost-full volume selection (command_ec_encode.go:258-290).

    Without per-volume mtime on the wire we use size >= fullness * limit;
    quiet_seconds=0 disables the quiet filter (used by tests/admin force).
    """
    if volume_size_limit is None:
        status = await env.master_get("/cluster/status")
        volume_size_limit = status.get("volume_size_limit", 0) or 0
    vids = []
    for node in await env.list_nodes():
        for m in node["volumes"]:
            if collection and m["collection"] != collection:
                continue
            if volume_size_limit and \
                    m["size"] < fullness * volume_size_limit:
                continue
            vids.append(m["id"])
    return sorted(set(vids))


async def ec_encode_volume(env: CommandEnv, vid: int,
                           collection: str = "",
                           generate: bool = True,
                           locations: list[str] | None = None) -> dict:
    """doEcEncode for one volume (command_ec_encode.go:89-117).

    generate=False skips steps 1-2 (already done by the batched generate
    in ec_encode); `locations` passes replica urls already looked up by
    the caller."""
    if locations is None:
        lookup = await env.master_get("/dir/lookup", volumeId=str(vid))
        if "locations" not in lookup:
            raise RuntimeError(f"volume {vid} not found")
        locations = [l["url"] for l in lookup["locations"]]
    source = locations[0]

    if generate:
        # 1. mark readonly everywhere (:119)
        for url in locations:
            await env.node_post(url, "/admin/volume/readonly",
                                volume=str(vid))
        # 2. generate 14 shards + .ecx on the source (:139)
        await env.node_post(source, "/admin/ec/generate", volume=str(vid),
                            collection=collection)

    # 3. spread shards across servers round-robin by free slots (:153-256)
    nodes = await collect_ec_nodes(env)
    assignments = balanced_ec_distribution(nodes, source)
    copies = []
    for target, shard_ids in assignments.items():
        if target == source or not shard_ids:
            continue
        copies.append(env.node_post(
            target, "/admin/ec/copy", volume=str(vid),
            collection=collection, source=source,
            shards=",".join(map(str, shard_ids)), copy_ecx="1"))
    await asyncio.gather(*copies)

    # 4. on every holder (copies are complete): drop the shard files not
    # assigned to it, then mount what remains (:177)
    for target, shard_ids in assignments.items():
        if not shard_ids:
            continue
        extras = [s for s in range(gf.TOTAL_SHARDS) if s not in shard_ids]
        if extras:
            await env.node_post(target, "/admin/ec/delete_shards",
                                volume=str(vid), collection=collection,
                                shards=",".join(map(str, extras)))
        await env.node_post(target, "/admin/ec/mount", volume=str(vid),
                            collection=collection)

    # 5. delete the original volume on all replicas (:177-195)
    for url in locations:
        await env.node_post(url, "/admin/volume/delete", volume=str(vid))
    return {"volume": vid, "assignments": assignments}


def balanced_ec_distribution(nodes: list[dict],
                             source: str) -> dict[str, list[int]]:
    """Round-robin the 14 shards over servers by free slots
    (balancedEcDistribution, command_ec_encode.go:240-256)."""
    if not nodes:
        return {source: list(range(gf.TOTAL_SHARDS))}
    alloc: dict[str, list[int]] = {n["url"]: [] for n in nodes}
    free = {n["url"]: max(n["freeSlots"], 0) for n in nodes}
    urls = list(alloc)
    i = 0
    for sid in range(gf.TOTAL_SHARDS):
        # next node with capacity, preferring emptier ones round-robin
        for _ in range(len(urls)):
            url = urls[i % len(urls)]
            i += 1
            if free[url] > 0 or all(f <= 0 for f in free.values()):
                alloc[url].append(sid)
                free[url] -= 1
                break
    return {u: s for u, s in alloc.items() if s}


async def ec_encode(env: CommandEnv, collection: str = "",
                    vids: list[int] | None = None,
                    fullness: float = 0.95) -> list[dict]:
    """ec.encode command entry (command_ec_encode.go:55).

    Volumes co-located on one server generate their shards through ONE
    batched device call (/admin/ec/generate_batch): the rack-encode shape
    where the kernel launch amortises over every co-located volume
    (parallel/mesh.py's "vol" axis; the reference loops serially)."""
    if vids is None:
        vids = await collect_volume_ids_for_ec_encode(
            env, collection, fullness=fullness)
    # group volumes by their generating (first-replica) server
    by_source: dict[str, list[int]] = {}
    locations: dict[int, list[str]] = {}
    for vid in vids:
        lookup = await env.master_get("/dir/lookup", volumeId=str(vid))
        if "locations" not in lookup:
            raise RuntimeError(f"volume {vid} not found")
        locations[vid] = [l["url"] for l in lookup["locations"]]
        by_source.setdefault(locations[vid][0], []).append(vid)
    for vid, urls in locations.items():
        for url in urls:
            await env.node_post(url, "/admin/volume/readonly",
                                volume=str(vid))
    await asyncio.gather(*(
        env.node_post(source, "/admin/ec/generate_batch",
                      volumes=",".join(map(str, svids)),
                      collection=collection)
        for source, svids in by_source.items()))
    results = []
    for vid in vids:
        results.append(await ec_encode_volume(env, vid, collection,
                                              generate=False,
                                              locations=locations[vid]))
    return results


# ---------------------------------------------------------------------------
# ec.rebuild (command_ec_rebuild.go)
# ---------------------------------------------------------------------------


async def ec_shard_map(env: CommandEnv) -> dict[int, dict]:
    """vid -> {collection, shards: {sid: [urls]}} from node ec registries."""
    out: dict[int, dict] = {}
    for node in await env.list_nodes():
        for m in node["ecShards"]:
            e = out.setdefault(m["id"], {"collection": m["collection"],
                                         "shards": {}})
            for sid in pb.shard_bits_list(m["ec_index_bits"]):
                e["shards"].setdefault(sid, []).append(node["url"])
    return out


async def ec_verify(env: CommandEnv, collection: str = "",
                    volume_id: int | None = None,
                    window_mb: int = 4) -> list[dict]:
    """Parity-scrub EC volumes cluster-wide: for each EC volume, ask a
    shard-holding server to recompute RS(10,4) parity over every stripe
    window (/admin/ec/verify -> EcVolume.verify_parity, TPU-backed when
    a chip is attached) and report corrupt windows. A no-reference-
    -equivalent capability: the reference's integrity checking stops at
    per-needle CRCs on read (needle/crc.go)."""
    results: list[dict] = []
    for vid, info in sorted((await ec_shard_map(env)).items()):
        if volume_id is not None and vid != volume_id:
            continue
        if collection and info["collection"] != collection:
            continue
        # the server holding the most shards verifies the most locally
        counts: dict[str, int] = {}
        for urls in info["shards"].values():
            for u in urls:
                counts[u] = counts.get(u, 0) + 1
        if not counts:
            continue
        node = max(counts, key=counts.get)  # type: ignore[arg-type]
        try:
            report = await env.node_post(node, "/admin/ec/verify",
                                         volume=str(vid),
                                         windowMB=str(window_mb))
        except RuntimeError as e:
            report = {"volume": vid, "error": str(e)[:200]}
        report["node"] = node
        results.append(report)
    return results


async def ec_rebuild(env: CommandEnv, collection: str = "",
                     apply_changes: bool = True) -> list[dict]:
    """Rebuild every deficient EC volume (10 <= shards < 14); <10 shards is
    unrepairable (command_ec_rebuild.go:93-243)."""
    results = []
    shard_map = await ec_shard_map(env)
    nodes = await collect_ec_nodes(env)
    for vid, info in sorted(shard_map.items()):
        if collection and info["collection"] != collection:
            continue
        have = sorted(info["shards"])
        if len(have) == gf.TOTAL_SHARDS:
            continue
        if len(have) < gf.DATA_SHARDS:
            results.append({"volume": vid, "error":
                            f"unrepairable: only {len(have)} shards"})
            continue
        if not apply_changes:
            results.append({"volume": vid, "missing":
                            [s for s in range(gf.TOTAL_SHARDS)
                             if s not in have]})
            continue
        rebuilder = nodes[0]["url"]
        # gather >=10 input shards onto the rebuilder (prepareDataToRecover)
        copied = []
        for sid in have:
            holders = info["shards"][sid]
            if rebuilder in holders:
                continue
            await env.node_post(rebuilder, "/admin/ec/copy",
                                volume=str(vid),
                                collection=info["collection"],
                                source=holders[0],
                                shards=str(sid), copy_ecx="1")
            copied.append(sid)
        # regenerate missing (VolumeEcShardsRebuild)
        resp = await env.node_post(rebuilder, "/admin/ec/rebuild",
                                   volume=str(vid),
                                   collection=info["collection"])
        rebuilt = resp.get("rebuilt", [])
        # drop the borrowed input shards, keep the rebuilt ones
        if copied:
            await env.node_post(rebuilder, "/admin/ec/delete_shards",
                                volume=str(vid),
                                collection=info["collection"],
                                shards=",".join(map(str, copied)))
        await env.node_post(rebuilder, "/admin/ec/mount", volume=str(vid),
                            collection=info["collection"])
        results.append({"volume": vid, "rebuilt": rebuilt,
                        "node": rebuilder})
    return results


# ---------------------------------------------------------------------------
# ec.decode (command_ec_decode.go): sealed EC volume -> normal volume
# ---------------------------------------------------------------------------


async def ec_decode_volume(env: CommandEnv, vid: int, info: dict) -> dict:
    """doEcDecode for one volume (command_ec_decode.go:71-99): gather the
    data shards on the holder with the most of them, reassemble
    .dat/.idx there (VolumeEcShardsToVolume), mount it as a normal
    volume, then tear down every EC shard."""
    coll = info["collection"]
    per_node: dict[str, set[int]] = {}
    for sid, holders in info["shards"].items():
        for url in holders:
            per_node.setdefault(url, set()).add(sid)
    if not per_node:
        return {"volume": vid, "error": "no shard holders"}
    # target = server already holding the most shards (collectEcShards)
    target = max(per_node, key=lambda u: len(per_node[u]))
    have = set(per_node[target])

    # if any data shard exists nowhere, it must be rebuilt on the target
    # (needs >=10 gathered shards); otherwise just copy the missing data
    # shards over
    absent_data = [s for s in range(gf.DATA_SHARDS)
                   if s not in info["shards"]]
    needed = (sorted(info["shards"]) if absent_data
              else [s for s in range(gf.DATA_SHARDS)])
    for sid in needed:
        if absent_data and len(have) >= gf.DATA_SHARDS:
            break  # rebuild needs only 10 gathered shards
        if sid in have or sid not in info["shards"]:
            continue
        await env.node_post(target, "/admin/ec/copy", volume=str(vid),
                            collection=coll,
                            source=info["shards"][sid][0],
                            shards=str(sid), copy_ecx="1")
        have.add(sid)
    if absent_data:
        if len(have) < gf.DATA_SHARDS:
            return {"volume": vid, "error":
                    f"unrepairable: only {len(have)} shards"}
        await env.node_post(target, "/admin/ec/rebuild", volume=str(vid),
                            collection=coll)

    # reassemble .dat/.idx (VolumeEcShardsToVolume)
    await env.node_post(target, "/admin/ec/to_volume", volume=str(vid),
                        collection=coll)
    # mount the normal volume, then unmount + delete EC state everywhere
    # (mountVolumeAndDeleteEcShards order: mount first, teardown after)
    await env.node_post(target, "/admin/volume/mount", volume=str(vid),
                        collection=coll)
    all_shards = ",".join(map(str, range(gf.TOTAL_SHARDS)))
    for url in per_node:
        await env.node_post(url, "/admin/ec/unmount", volume=str(vid))
        await env.node_post(url, "/admin/ec/delete_shards",
                            volume=str(vid), collection=coll,
                            shards=all_shards, ecx="1")
    return {"volume": vid, "node": target}


async def ec_decode(env: CommandEnv, collection: str = "",
                    vids: list[int] | None = None) -> list[dict]:
    """ec.decode command entry (command_ec_decode.go:37-69)."""
    shard_map = await ec_shard_map(env)
    results = []
    for vid, info in sorted(shard_map.items()):
        if collection and info["collection"] != collection:
            continue
        if vids and vid not in vids:
            continue
        try:
            results.append(await ec_decode_volume(env, vid, info))
        except RuntimeError as e:
            # one volume failing (e.g. 409 missing shard) must not
            # abort the rest of the batch (ec_rebuild reports the same
            # way)
            results.append({"volume": vid, "error": str(e)})
    return results


# ---------------------------------------------------------------------------
# ec.balance (command_ec_balance.go)
# ---------------------------------------------------------------------------


async def ec_balance(env: CommandEnv, collection: str = "",
                     apply_changes: bool = True) -> list[dict]:
    """Spread shards: no duplicate shard copies on one node, then even
    counts per node (dedup + spread steps of command_ec_balance.go:29-100).
    """
    moves = []
    shard_map = await ec_shard_map(env)
    nodes = await collect_ec_nodes(env)
    if not nodes:
        return moves
    url_free = {n["url"]: n["freeSlots"] for n in nodes}
    for vid, info in sorted(shard_map.items()):
        if collection and info["collection"] != collection:
            continue
        # count shards per node for this volume
        per_node: dict[str, list[int]] = {}
        for sid, holders in info["shards"].items():
            for url in holders:
                per_node.setdefault(url, []).append(sid)
        total = sum(len(s) for s in per_node.values())
        fair = -(-total // max(len(nodes), 1))
        over = {u: sorted(s) for u, s in per_node.items() if len(s) > fair}
        for src, sids in over.items():
            excess = sids[fair:]
            for sid in excess:
                # move to the node with the fewest shards of this volume
                candidates = sorted(
                    (u for u in url_free if u != src),
                    key=lambda u: (len(per_node.get(u, [])),
                                   -url_free.get(u, 0)))
                dst = next((u for u in candidates
                            if sid not in per_node.get(u, [])), None)
                if dst is None:
                    continue
                moves.append({"volume": vid, "shard": sid,
                              "from": src, "to": dst})
                if apply_changes:
                    await move_ec_shard(env, vid, info["collection"],
                                        sid, src, dst)
                per_node.setdefault(dst, []).append(sid)
                per_node[src].remove(sid)
    return moves


async def move_ec_shard(env: CommandEnv, vid: int, collection: str,
                        sid: int, src: str, dst: str) -> None:
    """moveMountedShardToEcNode (command_ec_common.go:18-75): copy to dst,
    mount there, unmount + delete on src."""
    await env.node_post(dst, "/admin/ec/copy", volume=str(vid),
                        collection=collection, source=src,
                        shards=str(sid), copy_ecx="1")
    await env.node_post(dst, "/admin/ec/mount", volume=str(vid),
                        collection=collection)
    await env.node_post(src, "/admin/ec/unmount", volume=str(vid),
                        shards=str(sid))
    await env.node_post(src, "/admin/ec/delete_shards", volume=str(vid),
                        collection=collection, shards=str(sid))
