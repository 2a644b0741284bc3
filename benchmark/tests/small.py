"""A copy of the benchmark's data files at a size a CPU test run holds:
the same cells, metrics and mixes, with the volumes, blocks, parts and
clients scaled down together."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMALL_CFG = {"volume_bytes": 3 << 20, "large_block_bytes": 1 << 20,
             "small_block_bytes": 32 << 10, "small_recover_bytes": 32 << 10,
             "needle_cache_bytes": 1 << 20}
SMALL_PARTS = {"s3parts-ec": 128 << 10}
SMALL_TRAFFIC = {"clients": 4, "samples": 16}


def make(dest: str) -> str:
    """Lay out a small root at `dest`: BENCHMARK.json and the benchmark's
    data and reader files, scaled. Returns dest."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    src = os.path.join(ROOT, "benchmark")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(src, sub),
                        os.path.join(dest, "benchmark", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name in os.listdir(os.path.join(dest, "benchmark", "configs")):
        path = os.path.join(dest, "benchmark", "configs", name)
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(SMALL_CFG)
        cfg["part_bytes"] = SMALL_PARTS[cfg["name"]]
        with open(path, "w") as f:
            json.dump(cfg, f)
    for name in os.listdir(os.path.join(dest, "benchmark", "traffic")):
        path = os.path.join(dest, "benchmark", "traffic", name)
        with open(path) as f:
            traffic = json.load(f)
        traffic.update({k: v for k, v in SMALL_TRAFFIC.items()
                        if k in traffic})
        with open(path, "w") as f:
            json.dump(traffic, f)
    return dest
