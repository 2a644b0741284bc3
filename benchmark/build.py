"""Set-up of a cell: the store a volume server would hold, built through
the program from the cell's seed.

Each volume's needles are written through `Store.write_needle`, the
volume is encoded into 14 shards by the program's `encode_volume` and
its `.ecx` written as `ec.encode` writes it, the `.dat` is deleted and
the shards are mounted. Then the traffic's lost shards are unmounted and
deleted.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from . import data


@dataclass
class Built:
    store: object
    plans: list
    buffers: dict                      # vid -> the parts' bytes (host)
    split: dict = field(default_factory=dict)   # set-up seconds by step


def build(cfg: dict, traffic: dict, seed: int, workdir: str,
          device) -> Built:
    from seaweedfs_tpu_torch.ec import pipeline as pl
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    split: dict = {}
    t = time.perf_counter()
    plans = data.plan(cfg)
    buffers = {p.vid: data.volume_bytes(seed, p, device) for p in plans}
    data.cookies(plans, seed)
    split["seed_data_s"] = time.perf_counter() - t

    store = Store([workdir], needle_cache_bytes=cfg["needle_cache_bytes"],
                  ec_large_block=cfg["large_block_bytes"],
                  ec_small_block=cfg["small_block_bytes"],
                  ec_small_recover_bytes=cfg["small_recover_bytes"])
    t = time.perf_counter()
    for p in plans:
        store.add_volume(p.vid)
        buf = buffers[p.vid]
        for part in p.parts:
            store.write_needle(p.vid, Needle(
                cookie=part.cookie, id=part.nid,
                data=buf[part.start:part.start + part.size].tobytes()))
        store.mark_readonly(p.vid)
    split["store_writes_s"] = time.perf_counter() - t

    t = time.perf_counter()
    bases = {}
    for p in plans:
        base = bases[p.vid] = store.volumes[p.vid].file_name()
        pl.encode_volume(base, large_block=store.ec_large_block,
                         small_block=store.ec_small_block)
        pl.write_sorted_file_from_idx(base)
    split["encode_s"] = time.perf_counter() - t

    t = time.perf_counter()
    lost = list(traffic.get("lost_shards", ()))
    for p in plans:
        store.unmount_volume(p.vid)
        store.delete_volume(p.vid)
        mounted = store.mount_ec_shards("", p.vid)
        if mounted != list(range(cfg["total_shards"])):
            raise RuntimeError(f"volume {p.vid} mounted shards {mounted}")
        if lost:
            store.unmount_ec_shards(p.vid, lost)
            for sid in lost:
                os.remove(bases[p.vid] + pl.to_ext(sid))
    split["mount_s"] = time.perf_counter() - t
    return Built(store=store, plans=plans, buffers=buffers, split=split)

