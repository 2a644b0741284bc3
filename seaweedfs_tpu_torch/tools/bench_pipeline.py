"""End-to-end EC pipeline ratio benchmark.

The port of the JAX package's tools/bench_pipeline.py. Measures, in the
SAME run so the arithmetic is checkable:
  1. host->device GB/s: a pinned host buffer of buffer_mb copied to the
     card;
  2. the kernel's GB/s at the pipeline's buffer (K1, the CUDA kernel of
     ops/gf256_cuda.py: one buffer split into 10 data shards, parity
     out);
  3. `write_ec_files` GB/s on a real .dat volume file through the
     port's TorchEncoder (ec/pipeline.py overlaps file reads, launches
     and shard writes);
and prints one JSON line: pipeline vs min(kernel, transfer) bound.

Usage:  python -m seaweedfs_tpu_torch.tools.bench_pipeline [size_mb]
            [buffer_mb]
Env:    SWTPU_TORCH_EC_BACKEND=cpu runs the plain PyTorch version on the
        host (a self-test of the harness); no card is asked for, so
        host_to_device_GBps is null and the bound is the kernel's rate.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np


def write_dat(base: str, size_mb: int) -> None:
    """A .dat of size_mb MiB of bytes from a seeded generator."""
    rng = np.random.default_rng(1)
    with open(base + ".dat", "wb") as f:
        left = size_mb << 20
        chunk = 64 << 20
        while left > 0:
            f.write(rng.integers(0, 256, min(chunk, left))
                    .astype(np.uint8).tobytes())
            left -= min(chunk, left)


def run(size_mb: int = 1024, buffer_mb: int = 16,
        workdir: str | None = None) -> dict:
    """The three rates as one dict. The volume is written into workdir
    (its base name "1") and left there when workdir is given, else into
    a temporary directory that is removed."""
    import torch

    from ..ec import gf
    from ..ec import pipeline as ecpl
    from ..ec.encoder_torch import device_consts
    from ..ops.gf256_cuda import gf256_transform

    out: dict = {"metric": "ec_pipeline_GBps", "volume_mb": size_mb,
                 "buffer_mb": buffer_mb}
    enc = ecpl.get_encoder()
    dev = enc.device
    out["backend"] = "gpu" if dev.type == "cuda" else "cpu"

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # tiny probe first: a card that cannot take a copy fails here
    torch.ones(256, dtype=torch.uint8).to(dev)
    sync()

    buf = np.random.default_rng(0).integers(
        0, 256, buffer_mb << 20).astype(np.uint8)
    iters = 4
    # 1. host->device GB/s: one buffer-sized copy from pinned memory,
    # repeated (the pipeline stages each block through pinned memory)
    if dev.type == "cuda":
        pinned = torch.from_numpy(buf).pin_memory()
        pinned.to(dev, non_blocking=True)  # warm
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            pinned.to(dev, non_blocking=True)
        sync()
        dt = (time.perf_counter() - t0) / iters
        out["host_to_device_GBps"] = round(len(buf) / dt / 1e9, 3)
    else:
        out["host_to_device_GBps"] = None

    # 2. the kernel's GB/s at the pipeline's working shape: one buffer
    # split into 10 data shards => buffer_mb/10 per shard
    shard = np.ascontiguousarray(
        buf[:(len(buf) // gf.DATA_SHARDS // 512 * 512) * gf.DATA_SHARDS]
        .reshape(1, gf.DATA_SHARDS, -1))
    x = torch.from_numpy(shard).to(dev)
    consts = device_consts(gf.parity_matrix(), dev)
    gf256_transform(consts, x)  # warm
    sync()
    k_iters = 50 if dev.type == "cuda" else iters
    t0 = time.perf_counter()
    for _ in range(k_iters):
        gf256_transform(consts, x)
    sync()
    dt = (time.perf_counter() - t0) / k_iters
    out["kernel_GBps"] = round(shard.size / dt / 1e9, 3)
    del x

    # 3. the real file pipeline on a .dat volume
    tmp = workdir or tempfile.mkdtemp(prefix="swtpu_torch_benchpipe_")
    base = os.path.join(tmp, "1")
    try:
        write_dat(base, size_mb)
        t0 = time.perf_counter()
        ecpl.write_ec_files(base, encoder=enc,
                            buffer_size=buffer_mb << 20)
        dt = time.perf_counter() - t0
        out["pipeline_GBps"] = round((size_mb << 20) / dt / 1e9, 3)
        out["pipeline_seconds"] = round(dt, 3)
        rates = [r for r in (out["kernel_GBps"],
                             out["host_to_device_GBps"]) if r is not None]
        bound = min(rates)
        out["bound_GBps"] = round(bound, 3)
        out["pipeline_vs_bound"] = round(
            out["pipeline_GBps"] / bound, 3) if bound else 0.0
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    return out


def main(argv: "list[str] | None" = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    size_mb = int(argv[0]) if len(argv) > 0 else 1024
    buffer_mb = int(argv[1]) if len(argv) > 1 else 16
    print(json.dumps(run(size_mb, buffer_mb)), flush=True)


if __name__ == "__main__":
    main()
