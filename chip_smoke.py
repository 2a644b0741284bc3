#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (seaweedfs_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--volume-mib N] [--flagship-mib N]
                          [--mesh-volumes N] [--mesh-mib N] [--store-mib N]
                          [--server-mib N] [--mxu-extra-mib N]
                          [--workers-mib N] [--gateway-mib N]
                          [--mount-mib N]
                          [--parent-k5 DIR]

Builds the port's CUDA sources from this checkout (the GF(256) kernel,
the fused kernel of the GF(2) bit-matrix product and the CRC32C kernel),
then:

1. prints the device facts (nvidia-smi name and power limit, torch and
   CUDA versions, kernel build time, the compiler's register report and
   the static SASS opcode mix of each kernel instance the main path
   runs);
2. holds the GF(256) kernel byte-equal to its plain PyTorch version on
   the card: encode (4x10), rebuild for lost {0,3,7,9}, {10,11,12,13},
   {2,11} and {5}, rows=1, rows=k=16, every byte value at every byte
   lane of a chunk in every input row (encode and a random 4x10), rows
   5, 8 and 13 (partial groups of 4 rows), k=1, many short windows, the
   pipeline's (8, 10, 1 MiB) block, a ragged L = 1 MiB + 3, a strided
   (B, 14, L)[:, :10] view and views whose rows start 1..15 bytes off a
   16-byte boundary; and its stacked entry (K2's port) writing into a
   strided (B, 14, L)[:, 10:] view at a ragged L = 264 * 512 + 5 and
   into out= views 1..15 bytes off a 16-byte boundary; and the GF(2)
   bit-matrix product (K4's port) byte-equal to its plain version and to
   the GF(256) kernel: encode 4x10, rebuild for lost {0,3,7,9}, rows=1,
   rows=k=16, k=1, every byte value in every input row, a ragged L =
   1 MiB + 3, L under 17 bytes, the pipeline block, a strided view, rows
   off a 16-byte boundary, and calls for which the plain version takes
   several chunks (the kernel takes none); and the CRC32C kernel (K5's
   port) equal to its plain version and the host CRC on the lengths,
   edge rows and blocks of tests/test_crc32c_jax.py, strided rows, rows
   1, 5 and 15 bytes off a 16-byte boundary, (64, 1 MiB), rows one byte
   under and over each span size, (4096, 4096) (also in 64-byte spans,
   more tiles than blocks) and 65,537 rows of 16 bytes, and one 128 MiB
   row (to the host CRC alone) whose tile states stage 2 carries in 8
   chunks;
3. runs the flagship steps of models/ec_model.py (encode, rebuild of
   lost {0,3,7,9}, verify) on 10 shards x 256 MiB resident on the card,
   checks each against the plain version and times it;
4. runs the volume path that /admin/ec/generate and /admin/ec/rebuild
   call: a 1 GiB .dat made from --seed is encoded by
   pipeline.encode_volume, indexed by write_sorted_file_from_idx, four
   shards are deleted and rebuilt by rebuild_ec_files, the .dat is
   decoded back by write_dat_file, and every window is verified by
   batch.verify_block before and after one flipped byte;
5. times the kernel and its plain version at the pipeline's block shape,
   and the fused bit-matrix kernel beside the GF(256) kernel, its plain
   version, its bound and its registers and spills at that block and at
   one 1 MiB rows=1 recover (time_mxu(..., parent=load_parent_k4(DIR))
   adds an earlier K4 from DIR's copies of its two files, in turns with
   the fused kernel); and the CRC32C kernel on bench.py's path (its only
   caller in the JAX package: (64, 1 MiB) rows, each held to the host
   CRC) with its plain version, its bound, each kernel's registers,
   spills and shared memory, the split of its time (split_crc32c: stage
   1 in each variant of the source, stage 2, every span size) and, where
   git can show commit K5_PARENT's K5 (or --parent-k5 names a directory
   of its two files), that kernel held equal and timed in turns with
   this one;
6. runs the multi-device mesh path (parallel/mesh.py) on a one-rank NCCL
   group: full_cycle_step on --mesh-volumes x 10 shards x --mesh-mib MiB
   made from --seed, then batched_verify clean and after one flipped
   parity byte, each held against the plain version; times the stacked
   entry at the rank's encode and rebuild blocks;
7. runs the store tier as a volume server drives it (storage/store.py,
   ec/ec_volume.py, ec/scrub.py) with the server's defaults (32 MiB
   needle cache, 1 MiB recover threshold): writes needles from --seed
   into one volume until its .dat reaches --store-mib MiB, EC-generates
   and mounts it, reads every needle intact (pass A), verifies parity,
   scrubs one flipped byte of .ec12, reads every needle with shards
   {0,3,7,9} lost (pass B) and again with every recover on the card
   (pass C, a sample held against the plain version), rebuilds, verifies
   and reads again; checks each step's kernel launches against its
   geometry, traces part of pass B and times the host-vs-card recover
   crossover;
8. runs the volume server (server/volume_server.py) as its users drive
   it, over HTTP: starts it in process through the port CLI's start-up
   coroutine (cli.start_volume, -ecBackend gpu, the -cache.mem and
   -ec.smallrecover defaults, no master), POSTs the needles of phase 7's
   generator until the .dat reaches --server-mib MiB, calls
   /admin/ec/generate (parity held to the host CpuEncoder), GETs every
   needle intact (pass A) and with shards {0,3,7,9} deleted (pass B),
   calls /admin/ec/rebuild (sha256-equal to the deleted files),
   /admin/ec/verify clean and after one flipped byte of .ec12, and a
   forced /debug/scrub cycle that must localize it to shard 12; checks
   each step's kernel launches against its geometry and reports;
9. starts a fresh server with SWTPU_TORCH_EC_METHOD=mxu on phase 8's
   sealed volume and one more volume of --mxu-extra-mib MiB written over
   HTTP: /admin/ec/generate_batch of both (parity sha256-equal to phase
   8's and to the host CpuEncoder's), every needle of phase 8's volume
   with shards {0,3,7,9} deleted (the same recovers as phase 8, through
   the bit-matrix product), /admin/ec/rebuild and a forced scrub cycle
   that localizes a flipped byte of .ec12 through it; checks each step's
   launches of both kernels;
10. runs `python -m seaweedfs_tpu_torch.cli volume -workers 2 -ecBackend
   gpu` on a free port: one volume of --workers-mib MiB in each worker's
   partition written through the shared port, /admin/ec/generate of both
   (ceil(W/8) dispatches, parity equal to the host CpuEncoder's), the
   needles of worker 1's volume read with 4 shards lost, each worker
   holding a CUDA context of its own, and again after worker 1 is
   SIGKILLed and respawned;
11. runs the port's own cluster, no module of seaweedfs_tpu in any of
   its processes: a port master (cli.start_master, -volumeSizeLimitMB
   --server-mib, an unpaced -autopilot.mbps 0) and two port volume servers
   (cli.start_volume, -ecBackend gpu) in process, and the port's shell in
   process and through `python -m seaweedfs_tpu_torch.cli shell -c` in a
   subprocess whose -X importtime log lists no jax module. Phase 8's
   sealed volume of --server-mib MiB (hard-linked) is the EC volume, and
   --cluster-assign-mib more go through /dir/assign and POST. ec.encode
   spreads its shards over both servers (parity sha256-equal to phase
   8's); every needle is read through /dir/lookup and GET intact and
   with 4 shards of one server lost (recovers gather the other's
   shards); a forced autopilot cycle rebuilds them with remote sources
   (sha256-equal); ec.verify runs clean and finds one flipped byte of
   .ec12, which a forced scrub localizes; ec.rebuild regenerates .ec12
   and 3 shards of the other server (sha256-equal); ec.decode, with data
   shard 0 lost, rebuilds it and reassembles a .dat sha256-equal to the
   original; checks each step's kernel launches against its geometry;
12. runs the filer tier on the port's own cluster, no module of
   seaweedfs_tpu in any of its processes: a port master (its volume
   limit twice --server-mib), two port volume servers (-ecBackend gpu)
   and a port filer (cli.start_filer at the CLI defaults: -store sqlite,
   -chunkSizeMB 32, -cache.mem 64, a collection of its own) in process.
   A tree of about --server-mib bytes made from --seed (a GiB of it
   about 2,000 files of 1-64 KiB and about 50 of 1-96 MiB; 42
   directories, three deep) goes in through `python -m
   seaweedfs_tpu_torch.cli filer.copy` in a subprocess whose -X
   importtime log lists no jax module; every directory is listed
   (equal to the tree), every file read through the filer (sha256) and
   20 Range GETs across chunk boundaries run;
   ec.encode -collection encodes the chunks' volume; 4 shards of one
   server are lost; the filer restarts on its sqlite store with a cold
   chunk cache; every file and the same ranges are read again, the
   degraded chunks recovered by K1; fs.du, fs.ls and fs.meta.notify run
   through the shell and /cluster/shards answers; holds each step's
   launches to its count from the .ecx and to filer_prediction, the
   reckoning from the seed alone;
13. runs the gateways, no module of seaweedfs_tpu in any of their
   processes: the port's combined `server -filer -s3` through
   cli.start_server in process (a SqliteQueue attached to its filer), a
   standalone `cli s3` with SigV4 credentials and a `cli webdav` in
   subprocesses on its master. Phase 12's tree of --gateway-mib bytes is
   PUT as objects of bucket gw13 through the anonymous S3, 8 at a time
   (multipart in 8 MiB parts from 8 MiB on, as boto3 sends), listed by
   prefix and delimiter, read and range-read (sha256, and the ETags the
   reference's gateway gives); a signed set goes through the standalone
   gateway (header auth over the payload hash, aws-chunked streams in 64
   KiB chunks; a wrong secret and a tampered chunk refused, the tampered
   upload's stored chunk deleted); a WebDAV set through MKCOL, PUT,
   PROPFIND, MOVE and GET; ec.encode -collection of each of the three
   collections through `cli shell -c`; shards {0,2,4,6} of every EC
   volume lost; both gateways restarted cold; every object and 20 ranges
   through the combined S3, every signed object by presigned GET, every
   WebDAV file, and `cli filer.replicate -once` from the queue into a
   local tree, all sha256-equal, the degraded chunks recovered by K1 in
   this process; holds each step's launches to its count from the .ecx
   and to gateway_prediction, the reckoning from the seed alone;
14. runs the FUSE mount, no module of seaweedfs_tpu in this process: a
   port master and two port volume servers (-ecBackend gpu, -cache.mem
   512) in process, a WFS over Filer("memory") with a collection of its
   own and the 4 MiB chunk limit, as `cli mount` builds it, wrapped in
   SeaweedFuseOps and served by the port's fusekernel.FUSE request loop
   over a SOCK_SEQPACKET socketpair, whose other end the phase drives as
   the kernel with FUSE 7.31 requests: INIT; MKDIR, then
   CREATE/WRITE/FLUSH/RELEASE of phase 12's tree of --mount-mib bytes in
   128 KiB WRITEs, one file after another; READDIR, LOOKUP and GETATTR
   equal to the tree; OPEN/READ/RELEASE of every file in 128 KiB READs
   (sha256); a RENAME, an UNLINK and SETXATTR/GETXATTR; ec.encode
   -collection through the port's shell (every record of the .dat where
   the seed puts it); shards {0,3,7,9} lost and the servers' caches
   emptied; every file again through READs (sha256), the degraded chunks
   recovered by K1; one READ at the start of each chunk of the largest
   file with the caches emptied before each; DESTROY; holds each step's
   launches to its count from the .ecx and to mount_prediction, the
   reckoning from the seed alone;
15. runs the port's `rebuild` soak (seaweedfs_tpu_torch/tools/soak.py,
   scenario_rebuild) as `python -m seaweedfs_tpu_torch.tools.soak
   rebuild` runs it, on subprocess daemons: a port master and 4 port
   volume servers at their default -ecBackend
   auto (the GPU), 900 files of 500-30,000 B at replication 000,
   `ec.encode -fullPercent 1` through the shell subprocess, a SIGKILLed
   shard holder, `ec.rebuild -force`, every file verified after each
   step with 0 bad reads; right after ec.encode every live server that
   received /admin/ec/generate, and right after ec.rebuild the
   rebuilding server, holds a CUDA context (K1 ran in it); no daemon or
   shell run imported jax or seaweedfs_tpu (PYTHONPROFILEIMPORTTIME=1
   logs); nothing left running;
   then prints one JSON line describing each kernel.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero and prints no
result; so does a host without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import posixpath
import shutil
import re
import struct
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

from seaweedfs_tpu_torch.ec import batch as ecb
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.encoder_torch import device_consts
from seaweedfs_tpu_torch.models import ec_model
from seaweedfs_tpu_torch.ops import _build, gf256_cuda, gf256_mxu
from seaweedfs_tpu_torch.ops.gf256_cuda import (
    gf256_stacked_transform, gf256_stacked_transform_reference,
    gf256_transform, gf256_transform_reference)
from seaweedfs_tpu_torch.ops.gf256_mxu import (
    device_bitmatrix, gf2_bitmatrix_transform,
    gf2_bitmatrix_transform_reference)
from seaweedfs_tpu_torch.parallel import dist as pdist
from seaweedfs_tpu_torch.parallel import mesh as pmesh
from seaweedfs_tpu_torch.storage import types as st
from seaweedfs_tpu_torch.storage.needle_map import pack_entry

ROOT = os.path.dirname(os.path.abspath(__file__))
# scratch space for the volume phase, inside the checkout (git-ignored)
WORK_DIR = os.path.join(ROOT, ".smoke_volume")

MIB = 1 << 20
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense
# int8 tensor-core operations/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# per Hopper SM: lanes of the INT32 pipe (shifts, LOP3, PRMT), and the
# 32 banks of shared memory, which serve one 32-bit load per lane a clock
INT32_LANES_PER_SM = 64
LDS_LANES_PER_SM = 32

LOST = [0, 3, 7, 9]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def present_for(lost: list[int]) -> list[int]:
    return [i for i in range(gf.TOTAL_SHARDS) if i not in lost][:gf.DATA_SHARDS]


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# cycles a second for torch.cuda._sleep: the H100's top SM clock (a card
# that runs slower only spins longer)
SPIN_HZ = 1.98e9


def cuda_ms(fn, iters: int, spin: bool = True) -> float:
    """Mean milliseconds of fn() on the card: CUDA events around `iters`
    calls after one warm-up call. With `spin` the stream first spins for
    twice the host time of those calls, at most 0.25 s
    (torch.cuda._sleep), so the calls are queued before the first one
    starts and the events see the device's time alone. Without it the
    calls run back to back, and where a call's host cost (checks, output
    allocation, launch) exceeds the device's time the events see the
    host's."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(int(min(2 * iters * host_s, 0.25) * SPIN_HZ))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max absolute byte difference of two uint8 tensors of one shape."""
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((torch.maximum(a, b) - torch.minimum(a, b)).max().item())


def bound(rows: int, k: int, bsz: int, length: int) -> dict:
    """Least time the card could take for a (rows x k) GF(256) transform
    of a (bsz, k, length) block: the larger of its bytes (each input read
    once, each output written once) over HBM bandwidth and its operations
    over the int8 tensor-core peak, counting the transform as its GF(2)
    bit-matrix product ((8 rows) x (8 k) multiply-adds per byte column).

    Also a model of the nibble-table kernel's instruction mix, per
    16-byte chunk of a window with G = ceil(rows / 4) groups of 4 rows:
    for each of the 4k input words, 12 INT32 operations of offsets (two
    shift-and-mask pairs, 8 __byte_perm) and 4 LOP3 per group, and 8
    shared loads (LDS) per group; then 32 __byte_perm per group for the
    4 x 4 transposes. It is the source's count, not the compiler's: the
    compiler issues some shifts as IMAD.SHL on the FMA pipe and adds
    address arithmetic (phase 1 prints the SASS mix)."""
    nbytes = bsz * (k + rows) * length
    ops = 2 * (8 * rows) * (8 * k) * bsz * length
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    groups = -(-rows // 4)
    chunks = bsz * -(-length // 16)
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "int_pipe_ops": chunks * (4 * k * (12 + 4 * groups)
                                      + 32 * groups),
            "lds_ops": chunks * 4 * k * 8 * groups}


# opcode of a SASS instruction line, after an optional predicate
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_mix(name: str) -> dict[str, Counter]:
    """Static count of each opcode (suffixes dropped) in every kernel
    function of csrc/<name>.cu's built library, from cuobjdump -sass."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", _build.library_path(name)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    mix: dict[str, Counter] = {}
    fn = None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            mix[fn] = Counter()
        elif fn is not None:
            m = SASS_LINE.match(line)
            if m:
                mix[fn][m.group(1)] += 1
    return mix


# -- phase 2: kernel vs plain version ---------------------------------------

def every_byte(k: int, dev: torch.device, bsz: int = 2) -> torch.Tensor:
    """(bsz, k, 4096) uint8 in which every value 0..255 stands at each of
    the 16 byte lanes of a chunk in every input row: byte p of chunk c of
    row i in window b is ((2b + 1) c + 17 p + 31 i) mod 256, and c runs
    over 256 chunks."""
    b = torch.arange(bsz, device=dev).view(bsz, 1, 1, 1)
    i = torch.arange(k, device=dev).view(1, k, 1, 1)
    c = torch.arange(256, device=dev).view(1, 1, 256, 1)
    p = torch.arange(16, device=dev).view(1, 1, 1, 16)
    x = ((2 * b + 1) * c + 17 * p + 31 * i) % 256
    return x.to(torch.uint8).reshape(bsz, k, 256 * 16)


def kernel_cases(dev: torch.device, seed: int, block: int = MIB
                 ) -> list[tuple]:
    """(name, consts, x) for every shape phase 2 holds the kernel to;
    `block` is the window of the pipeline-sized cases. The card runs
    them at 1 MiB; the tests rehearse them on the CPU at a small window,
    because there the plain version and the tests' numpy model of the
    kernel would take tens of seconds at 1 MiB."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    rng = np.random.default_rng(seed)

    def matrix(rows, k):
        return device_consts(rng.integers(0, 256, (rows, k)), dev)

    parity = device_consts(gf.parity_matrix(), dev)
    cases = [("encode 4x10 (2, 10, 64 KiB)", parity, rand(2, 10, 64 << 10)),
             (f"pipeline block (8, 10, {block})", parity,
              rand(8, 10, block)),
             (f"ragged L = {block} + 3", parity, rand(2, 10, block + 3)),
             (f"strided (8, 14, {block})[:, :10]", parity,
              rand(8, 14, block)[:, :gf.DATA_SHARDS])]
    for lost in ([0, 3, 7, 9], [10, 11, 12, 13], [2, 11], [5]):
        coeff = gf.shard_rows(lost, present_for(lost))
        cases.append((f"rebuild lost {lost} (rows={len(lost)})",
                      device_consts(coeff, dev), rand(3, 10, 300_001)))
    cases.append(("rows=1 ragged (1, 10, 4097)",
                  device_consts(gf.shard_rows([12], present_for([12])), dev),
                  rand(1, 10, 4097)))
    cases.append(("rows=16 k=16 (2, 16, 65 KiB + 1)",
                  device_consts(rng.integers(0, 256, (16, 16)), dev),
                  rand(2, 16, (65 << 10) + 1)))
    cases.append(("every byte at every lane, encode 4x10", parity,
                  every_byte(10, dev)))
    cases.append(("every byte at every lane, random 4x10", matrix(4, 10),
                  every_byte(10, dev)))
    for rows, k in ((5, 10), (8, 10), (13, 10), (13, 16)):
        cases.append((f"every byte at every lane, random {rows}x{k}",
                      matrix(rows, k), every_byte(k, dev)))
    cases.append(("k=1 random 4x1 (2, 1, 64 KiB + 7)", matrix(4, 1),
                  rand(2, 1, (64 << 10) + 7)))
    cases.append(("k=1 every byte at every lane, random 6x1", matrix(6, 1),
                  every_byte(1, dev)))
    windows = max(1, block * 40_000 // MIB)
    cases.append((f"many short windows ({windows}, 10, 33)", parity,
                   rand(windows, 10, 33)))
    base = rand(2, 10, 8192)
    for off in range(1, 16):
        cases.append((f"x rows {off} bytes off 16 (2, 10, 4101)", parity,
                      base[:, :, off:off + 4101]))
    return cases


def phase_kernel_vs_plain(dev: torch.device, seed: int,
                          block: int = MIB) -> int:
    """Every case of kernel_cases(dev, seed, block) byte-equal; returns
    the max absolute byte difference."""
    max_err = 0
    for name, consts, x in kernel_cases(dev, seed, block):
        got = gf256_transform(consts, x)
        want = gf256_transform_reference(consts, x)
        sync(dev)
        err = abs_err(got, want)
        max_err = max(max_err, err)
        print(f"  kernel vs plain: {name}: max_abs_err={err}")
        check(got.shape == want.shape and err == 0,
              f"kernel differs from its plain version: {name}")
    return max_err


def phase_stacked_vs_plain(dev: torch.device, seed: int) -> int:
    """The stacked entry (K2's port) byte-equal to its plain version on a
    ragged L = 264 * 512 + 5, writing into the strided parity rows
    (B, 14, L)[:, 10:] of a block and into a fresh output, and into out=
    views whose rows start 1..15 bytes off a 16-byte boundary, from
    aligned and from misaligned inputs; returns the max absolute byte
    difference."""
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    length = 264 * 512 + 5

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    x = rand(3, gf.DATA_SHARDS, length)
    max_err = 0
    for name, coeff in (("encode 4x10", gf.parity_matrix()),
                        (f"rebuild lost {LOST}",
                         gf.shard_rows(LOST, present_for(LOST)))):
        consts = device_consts(coeff, dev)
        block = rand(3, gf.TOTAL_SHARDS, length)
        plain = block.clone()
        got = gf256_stacked_transform(consts, x,
                                      out=block[:, gf.DATA_SHARDS:])
        gf256_stacked_transform_reference(consts, x,
                                          out=plain[:, gf.DATA_SHARDS:])
        fresh = gf256_stacked_transform(consts, x)
        sync(dev)
        err = max(abs_err(block, plain),
                  abs_err(fresh, plain[:, gf.DATA_SHARDS:]))
        max_err = max(max_err, err)
        print(f"  stacked vs plain: {name}, out=(3, 14, {length})[:, 10:] "
              f"and a fresh output: max_abs_err={err}")
        check(got.data_ptr() == block[:, gf.DATA_SHARDS:].data_ptr()
              and err == 0, f"stacked entry differs from its plain "
              f"version: {name}")

    consts = device_consts(gf.parity_matrix(), dev)
    n = 4096 + 5
    aligned = rand(2, gf.DATA_SHARDS, 4096 + 16)[:, :, :n]
    shifted = rand(2, gf.DATA_SHARDS, 8192)
    err = 0
    for off in range(1, 16):
        for xin in (aligned, shifted[:, :, off:off + n]):
            block = rand(2, gf.TOTAL_SHARDS, 8192)
            plain = block.clone()
            got = gf256_stacked_transform(
                consts, xin, out=block[:, gf.DATA_SHARDS:, off:off + n])
            gf256_stacked_transform_reference(
                consts, xin, out=plain[:, gf.DATA_SHARDS:, off:off + n])
            sync(dev)
            err = max(err, abs_err(block, plain))
            check(got.data_ptr() % 16 == off,
                  f"out= view starts {got.data_ptr() % 16} bytes off 16, "
                  f"expected {off}")
    max_err = max(max_err, err)
    print(f"  stacked vs plain: out= rows 1..15 bytes off 16 "
          f"(2, 14, 8192)[:, 10:, off:off + {n}], from aligned and from "
          f"shifted inputs: max_abs_err={err}")
    check(err == 0, "stacked entry differs from its plain version on "
          "misaligned out= views")
    return max_err


def mxu_cases(dev: torch.device, seed: int, block: int = MIB
              ) -> list[tuple]:
    """(name, coeff, x, chunk_bytes) for every shape phase 2 holds K4's
    port to; `block` is the window of the pipeline-sized cases (the tests
    rehearse them on the CPU at a small window)."""
    gen = torch.Generator(device=dev).manual_seed(seed + 5)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                             generator=gen)

    rng = np.random.default_rng(seed + 5)
    parity = gf.parity_matrix()
    # the default budget on the card; scaled with the window elsewhere
    chunk = gf256_mxu.CHUNK_BYTES * block // MIB
    per_col = 8 * gf.DATA_SHARDS + 32 * gf.PARITY_SHARDS
    cases = [
        ("encode 4x10 (2, 10, 64 KiB)", parity, rand(2, 10, 64 << 10),
         chunk),
        (f"rebuild lost {LOST} (3, 10, 300001)",
         gf.shard_rows(LOST, present_for(LOST)), rand(3, 10, 300_001),
         chunk),
        ("rows=1 (1, 10, 4097)", gf.shard_rows([12], present_for([12])),
         rand(1, 10, 4097), chunk),
        ("rows=k=16 (2, 16, 65 KiB + 1)", rng.integers(0, 256, (16, 16)),
         rand(2, 16, (65 << 10) + 1), chunk),
        ("k=1 random 4x1 (2, 1, 64 KiB + 7)", rng.integers(0, 256, (4, 1)),
         rand(2, 1, (64 << 10) + 7), chunk),
        ("every byte at every lane, encode 4x10", parity,
         every_byte(10, dev), chunk),
        ("every byte at every lane, random 13x16",
         rng.integers(0, 256, (13, 16)), every_byte(16, dev), chunk),
        (f"ragged L = {block} + 3", parity, rand(2, 10, block + 3), chunk),
        ("L = 13 under 17 bytes (1, 10, 13)", parity, rand(1, 10, 13),
         chunk),
        ("L = 1 (3, 10, 1)", parity, rand(3, 10, 1), chunk),
        (f"pipeline block (8, 10, {block})", parity, rand(8, 10, block),
         chunk),
        (f"strided (4, 14, {block // 4})[:, :10]", parity,
         rand(4, 14, block // 4)[:, :gf.DATA_SHARDS], chunk),
        ("x rows 3 bytes off 16 (2, 10, 4101)", parity,
         rand(2, 10, 8192)[:, :, 3:3 + 4101], chunk),
        ("small chunks of 1000 columns (8, 10, 64 KiB + 5)", parity,
         rand(8, 10, (64 << 10) + 5), per_col * 1000),
        ("small chunks of 3 windows (40, 10, 333)", parity,
         rand(40, 10, 333), per_col * 1000),
    ]
    # several chunks of the plain version at that budget: whole windows,
    # then column ranges of one window
    cols = chunk // per_col
    cases.append((f"several chunks of whole windows (64, 10, {block // 16})",
                  parity, rand(64, 10, block // 16), chunk))
    cases.append((f"several chunks of one window (2, 10, {4 * block})",
                  parity, rand(2, 10, 4 * block), chunk))
    for name, coeff, x, cb in cases:
        rows, k = np.asarray(coeff).shape
        n_chunks = len(list(gf256_mxu.chunks(x.shape[0], x.shape[2], k,
                                              rows, cb)))
        if "several" in name:
            check(n_chunks > 1, f"{name}: {n_chunks} chunk at {cols} "
                  f"columns a chunk")
    return cases


def phase_mxu_vs_plain(dev: torch.device, seed: int,
                       block: int = MIB) -> int:
    """K4's port byte-equal to its plain version and to K1 on every case
    of mxu_cases; returns the max absolute byte difference."""
    max_err = 0
    for name, coeff, x, cb in mxu_cases(dev, seed, block):
        bitmat = device_bitmatrix(coeff, dev)
        got = gf2_bitmatrix_transform(bitmat, x, cb)
        want = gf2_bitmatrix_transform_reference(bitmat, x, cb)
        k1 = gf256_transform(device_consts(coeff, dev), x)
        sync(dev)
        err = max(abs_err(got, want), abs_err(got, k1))
        max_err = max(max_err, err)
        rows, k = np.asarray(coeff).shape
        n_chunks = len(list(gf256_mxu.chunks(x.shape[0], x.shape[2], k,
                                              rows, cb)))
        print(f"  K4 vs plain and K1: {name}, one launch (the plain "
              f"version in {n_chunks} chunk(s)): max_abs_err={err}")
        check(err == 0, f"K4 differs from its plain version or K1: {name}")
    return max_err


# -- phase 3: flagship steps -------------------------------------------------

def phase_flagship(dev: torch.device, seed: int, n: int) -> dict:
    """ec_model encode, rebuild of LOST and verify on (10, n) shards
    resident on `dev`, each held against the plain version."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    data = torch.randint(0, 256, (gf.DATA_SHARDS, n), dtype=torch.uint8,
                         device=dev, generator=gen)
    encode = ec_model.make_encode_step(device=dev)
    present = present_for(LOST)
    rebuild = ec_model.make_rebuild_step(present, LOST, device=dev)
    verify = ec_model.make_verify_step(device=dev)

    before = gf256_cuda.launches
    shards = encode(data)
    survivors = shards[present]
    rebuilt = rebuild(survivors)
    mismatches = int(verify(shards).item())
    sync(dev)
    launched = gf256_cuda.launches - before

    want_parity = gf256_transform_reference(encode.consts, data[None])[0]
    check(torch.equal(shards[:gf.DATA_SHARDS], data),
          "encode step changed the data rows")
    check(torch.equal(shards[gf.DATA_SHARDS:], want_parity),
          "encode step parity differs from the plain version")
    want_rebuilt = gf256_transform_reference(rebuild.consts,
                                             survivors[None])[0]
    check(torch.equal(rebuilt, want_rebuilt),
          "rebuild step differs from the plain version")
    check(torch.equal(rebuilt, shards[LOST]),
          "rebuild step did not restore the lost shards")
    check(mismatches == 0, f"verify step counted {mismatches} mismatches")
    shards[12, n // 2] ^= 0x5A
    flipped = int(verify(shards).item())
    shards[12, n // 2] ^= 0x5A
    check(flipped == 1, f"verify step counted {flipped} after one flip")
    del want_parity, want_rebuilt
    print(f"  flagship steps on (10, {n}) held against plain: encode, "
          f"rebuild lost {LOST}, verify (0, then 1 after a flip)")
    return {"launches": launched, "data": data, "shards": shards,
            "survivors": survivors, "encode": encode, "rebuild": rebuild,
            "verify": verify}


def time_flagship(f: dict, card: str) -> None:
    n = f["data"].shape[1]
    k = gf.DATA_SHARDS
    runs = [
        ("encode", lambda: f["encode"](f["data"]),
         lambda: gf256_transform(f["encode"].consts, f["data"][None]), 4),
        ("rebuild-4", lambda: f["rebuild"](f["survivors"]),
         lambda: gf256_transform(f["rebuild"].consts, f["survivors"][None]),
         4),
        ("verify", lambda: f["verify"](f["shards"]),
         lambda: gf256_transform(f["verify"].consts,
                                 f["shards"][None, :k]), 4),
    ]
    for name, step, kernel, rows in runs:
        step_ms = cuda_ms(step, 5)
        kern_ms = cuda_ms(kernel, 10)
        b = bound(rows, k, 1, n)
        print(f"  flagship {name}: step {step_ms:.4f} ms, kernel "
              f"{kern_ms:.4f} ms = {k * n / kern_ms / 1e6:.2f} GB/s of "
              f"data shards; byte bound {b['bytes_ms']:.4f} ms "
              f"({b['bytes_ms'] / kern_ms:.3f} of it); [{card}]")


# -- phase 4: the volume path ------------------------------------------------

def make_volume(base: str, size: int, seed: int) -> str:
    """<base>.dat of `size` bytes (8-byte superblock + seeded bytes) and
    an .idx of records that tile it; returns the .dat's sha256."""
    rng = np.random.default_rng(seed)
    superblock = bytes([st.CURRENT_VERSION]) + bytes(7)
    body = rng.bytes(size - len(superblock))
    sha = hashlib.sha256(superblock)
    sha.update(body)
    with open(base + ".dat", "wb") as f:
        f.write(superblock)
        f.write(body)
    # records of 4088 bytes (4060-byte needle bodies), the last one
    # stretched to end exactly at `size`
    record = 4088
    n_rec = (size - len(superblock)) // record
    keys = rng.permutation(n_rec) + 1
    entries = []
    for i in range(n_rec):
        length = record if i < n_rec - 1 else \
            size - len(superblock) - record * (n_rec - 1)
        entries.append(pack_entry(int(keys[i]), len(superblock) + i * record,
                                  length - 28))
    with open(base + ".idx", "wb") as f:
        f.write(b"".join(entries))
    return sha.hexdigest()


def sha_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(64 * MIB), b""):
            h.update(chunk)
    return h.hexdigest()


def read_window(base: str, w: int, window: int) -> np.ndarray:
    """(14, window) stored rows of stripe window w."""
    rows = []
    for sid in range(gf.TOTAL_SHARDS):
        with open(base + pl.to_ext(sid), "rb") as f:
            f.seek(w * window)
            rows.append(np.frombuffer(f.read(window), np.uint8))
    return np.stack(rows)


def verify_all(encoder, base: str, n_windows: int, window: int,
               stats: dict) -> list[int]:
    """Window indices whose parity check fails, 8 windows per dispatch."""
    shards = [np.fromfile(base + pl.to_ext(s), np.uint8)
              for s in range(gf.TOTAL_SHARDS)]
    bad = []
    for w0, count in ecb.window_blocks(n_windows,
                                       ecb.DEFAULT_BATCH_WINDOWS):
        block = np.stack([s[w0 * window:(w0 + count) * window]
                          .reshape(count, window) for s in shards], axis=1)
        verdicts = ecb.verify_block(encoder, block, stats)
        bad += [w0 + i for i, ok in enumerate(verdicts) if not ok]
    return bad


def phase_volume(encoder, dev: torch.device, seed: int, size: int,
                 large_block: int = pl.LARGE_BLOCK_SIZE,
                 small_block: int = pl.SMALL_BLOCK_SIZE,
                 buffer_size: int = MIB) -> dict:
    """The /admin/ec/generate + /admin/ec/rebuild library path on a
    `size`-byte volume. Returns the counts main() checks."""
    shutil.rmtree(WORK_DIR, ignore_errors=True)
    os.makedirs(WORK_DIR)
    base = os.path.join(WORK_DIR, "1")
    seen = {}
    try:
        t0 = time.perf_counter()
        dat_sha = make_volume(base, size, seed)
        print(f"  volume: {size} bytes .dat + .idx made from seed {seed} "
              f"in {time.perf_counter() - t0:.2f} s")

        # what the encoder must do, from the geometry alone
        geo_windows = sum(1 for _ in pl._iter_row_batches(
            size, large_block, small_block, buffer_size))
        seen["expected_windows"] = geo_windows

        seen["launches_start"] = gf256_cuda.launches
        enc_stats: dict = {}
        t0 = time.perf_counter()
        pl.encode_volume(base, encoder=encoder, large_block=large_block,
                         small_block=small_block, buffer_size=buffer_size,
                         stats=enc_stats)
        sync(dev)
        seen["encode_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pl.write_sorted_file_from_idx(base)
        ecx_s = time.perf_counter() - t0
        seen["launches_after_encode"] = gf256_cuda.launches
        seen["encode_stats"] = enc_stats
        print(f"  encode_volume: {seen['encode_s']:.3f} s, stats "
              f"{enc_stats}; write_sorted_file_from_idx: {ecx_s:.3f} s")
        check(pl.find_dat_file_size(base) == size,
              "find_dat_file_size disagrees with the .dat written")
        check(enc_stats["windows"] == geo_windows,
              f"{enc_stats['windows']} windows, geometry says {geo_windows}")

        shard_size = os.path.getsize(base + pl.to_ext(0))
        n_windows = shard_size // buffer_size
        for w in (0, n_windows // 2, n_windows - 1):
            rows = read_window(base, w, buffer_size)
            x = torch.from_numpy(rows[None, :gf.DATA_SHARDS]).to(dev)
            want = gf256_transform_reference(
                device_consts(gf.parity_matrix(), dev), x)[0].cpu().numpy()
            check(np.array_equal(rows[gf.DATA_SHARDS:], want),
                  f"stored parity of window {w} differs from plain version")
        print(f"  parity of windows 0, {n_windows // 2}, {n_windows - 1} "
              f"equals the plain version on the card")

        originals = {s: sha_file(base + pl.to_ext(s))
                     for s in range(gf.TOTAL_SHARDS)}
        for s in LOST:
            os.remove(base + pl.to_ext(s))
        reb_stats: dict = {}
        seen["launches_before_rebuild"] = gf256_cuda.launches
        t0 = time.perf_counter()
        rebuilt = pl.rebuild_ec_files(base, encoder=encoder,
                                      buffer_size=buffer_size,
                                      stats=reb_stats)
        sync(dev)
        seen["rebuild_s"] = time.perf_counter() - t0
        seen["launches_after_rebuild"] = gf256_cuda.launches
        seen["rebuild_stats"] = reb_stats
        check(rebuilt == LOST, f"rebuilt {rebuilt}, lost {LOST}")
        for s in LOST:
            check(sha_file(base + pl.to_ext(s)) == originals[s],
                  f"rebuilt shard {s} differs from the original")
        print(f"  rebuild_ec_files of {LOST}: {seen['rebuild_s']:.2f} s, "
              f"sha256 of every rebuilt shard equals the original; stats "
              f"{ {k: v for k, v in reb_stats.items() if k != 'seconds'} }")

        os.remove(base + ".dat")
        pl.write_dat_file(base, pl.find_dat_file_size(base),
                          large_block=large_block, small_block=small_block)
        check(sha_file(base + ".dat") == dat_sha,
              "decoded .dat differs from the original")
        print("  write_dat_file: sha256 of the decoded .dat equals the "
              "original")

        ver_stats: dict = {}
        bad = verify_all(encoder, base, n_windows, buffer_size, ver_stats)
        check(bad == [], f"clean volume failed verify in windows {bad}")
        flip_w = n_windows // 3
        with open(base + pl.to_ext(12), "r+b") as f:
            f.seek(flip_w * buffer_size + 777)
            b = f.read(1)
            f.seek(flip_w * buffer_size + 777)
            f.write(bytes([b[0] ^ 0x01]))
        bad = verify_all(encoder, base, n_windows, buffer_size, ver_stats)
        check(bad == [flip_w],
              f"one flipped byte in window {flip_w}: failing windows {bad}")
        seen["launches_end"] = gf256_cuda.launches
        seen["verify_stats"] = ver_stats
        print(f"  verify_block: all {n_windows} windows pass; after one "
              f"flipped byte of .ec12 only window {flip_w} fails; stats "
              f"{ver_stats}")
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    return seen


def check_volume_counts(seen: dict) -> int:
    """Dispatch counts equal ceil(W/8) and equal the kernel's launches in
    each part; returns the launches of the whole volume path."""
    w = seen["expected_windows"]
    per = ecb.DEFAULT_BATCH_WINDOWS
    enc = seen["launches_after_encode"] - seen["launches_start"]
    check(seen["encode_stats"]["dispatches"] == math.ceil(w / per) == enc,
          f"encode: dispatches {seen['encode_stats']['dispatches']}, "
          f"ceil(W/8) {math.ceil(w / per)}, kernel launches {enc}")
    reb = seen["launches_after_rebuild"] - seen["launches_before_rebuild"]
    check(seen["rebuild_stats"]["dispatches"] == math.ceil(w / per) == reb,
          f"rebuild: dispatches {seen['rebuild_stats']['dispatches']}, "
          f"kernel launches {reb}")
    ver = seen["launches_end"] - seen["launches_after_rebuild"]
    check(seen["verify_stats"]["dispatches"] == 2 * math.ceil(w / per)
          == ver, f"verify: dispatches {seen['verify_stats']['dispatches']},"
          f" kernel launches {ver}")
    print(f"  W={w} windows: encode {enc}, rebuild {reb}, verify {ver} "
          f"kernel launches = ceil(W/8) per pass")
    return seen["launches_end"] - seen["launches_start"]


# -- phase 5: kernel timing ---------------------------------------------------

def report_timing(label: str, ms: float, b2b_ms: float, plain_ms: float,
                  b: dict, dev: torch.device, card: str) -> dict:
    """Print a kernel's time (device alone, and back to back with the
    wrapper's host cost) beside its bound and the modelled instruction
    count per pipe; returns the kernels-line numbers."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    int_ms = b["int_pipe_ops"] / (sms * INT32_LANES_PER_SM * clock_hz) * 1e3
    lds_ms = b["lds_ops"] / (sms * LDS_LANES_PER_SM * clock_hz) * 1e3
    print(f"  {label}: kernel "
          f"{ms:.4f} ms (device alone; back to back with the host's calls "
          f"{b2b_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} bytes; "
          f"GF(2) bit-matrix int8 ops {b['ops_ms']:.4f} ms), share "
          f"{b['bound_ms'] / ms:.3f} (back to back "
          f"{b['bound_ms'] / b2b_ms:.3f}); modelled nibble-table count at "
          f"{sms} SMs x {clock_hz / 1e6:.0f} MHz: INT32 pipe "
          f"{b['int_pipe_ops']} ops = {int_ms:.4f} ms, shared loads "
          f"{b['lds_ops']} LDS = {lds_ms:.4f} ms; [{card}]")
    print(f"  clocks.sm, power.draw after timing: "
          f"{smi('clocks.sm,power.draw')}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"]}


def time_pipeline_block(dev: torch.device, seed: int, card: str) -> dict:
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    bsz, k, length = ecb.DEFAULT_BATCH_WINDOWS, gf.DATA_SHARDS, MIB
    x = torch.randint(0, 256, (bsz, k, length), dtype=torch.uint8,
                      device=dev, generator=gen)
    consts = device_consts(gf.parity_matrix(), dev)
    ms = cuda_ms(lambda: gf256_transform(consts, x), 50)
    b2b_ms = cuda_ms(lambda: gf256_transform(consts, x), 50, spin=False)
    plain_ms = cuda_ms(lambda: gf256_transform_reference(consts, x), 5)
    return report_timing(f"pipeline block ({bsz}, {k}, {length}) encode",
                         ms, b2b_ms, plain_ms,
                         bound(consts.shape[0], k, bsz, length), dev, card)


# a gf2_bitmatrix_kernel<KS, NI> instance in a mangled name
K4_INSTANCE = re.compile(r"gf2_bitmatrix_kernelILi(\d+)ELi(\d+)E")


def k4_instance(rows: int, k: int) -> tuple[int, int]:
    """(KS, NI) of the instance swtpu_gf2_transform launches: k32 steps,
    and wgmma.m64n32k32 instructions (4 output rows each) per step."""
    return -(-k // 4), -(-rows // 4)


def ptxas_report(log: str) -> dict:
    """name -> {"registers", "spill_stores", "spill_loads"} of every
    entry function in an nvcc -Xptxas=-v log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_stores": None,
                       "spill_loads": None}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn]["spill_stores"] = int(m.group(1))
            out[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
    return out


def k4_registers(report: dict, rows: int, k: int) -> dict:
    """The ptxas numbers of the K4 instance for (rows, k), or {}."""
    want = k4_instance(rows, k)
    for fn, facts in report.items():
        m = K4_INSTANCE.search(fn)
        if m and tuple(int(v) for v in m.groups()) == want:
            return facts
    return {}


def load_parent_k4(parent: str):
    """The wrapper module of an earlier K4 from `parent`, a directory
    holding that commit's ops/gf256_mxu.py and ops/csrc/gf2_bitmatrix.cu
    (`git show <commit>:seaweedfs_tpu_torch/ops/gf256_mxu.py` and so on):
    both are copied into the package as gf256_mxu_parent.py and
    csrc/gf2_bitmatrix_parent.cu, the module is imported and built, and
    the copies are removed again (the built library stays in _build/)."""
    import importlib
    ops = os.path.dirname(_build.CSRC)
    py = os.path.join(ops, "gf256_mxu_parent.py")
    cu = os.path.join(_build.CSRC, "gf2_bitmatrix_parent.cu")
    with open(os.path.join(parent, "gf256_mxu.py")) as f:
        src = f.read().replace('_build.load("gf2_bitmatrix")',
                               '_build.load("gf2_bitmatrix_parent")')
    try:
        with open(py, "w") as f:
            f.write(src)
        shutil.copy(os.path.join(parent, "gf2_bitmatrix.cu"), cu)
        mod = importlib.import_module(
            "seaweedfs_tpu_torch.ops.gf256_mxu_parent")
        _build.load("gf2_bitmatrix_parent")
    finally:
        for path in (py, cu):
            if os.path.exists(path):
                os.remove(path)
    return mod


def time_mxu(dev: torch.device, seed: int, card: str, report: dict,
             block: int = MIB, timer=cuda_ms, parent=None) -> dict:
    """K4's fused kernel at the pipeline block (8, 10, `block`) encode and
    at one `block` rows=1 recover (1, 10, `block`), with K1 and the plain
    version on the same inputs in the same call, the bound and its share,
    and the instance's registers and spills from the ptxas `report`.
    With `parent` (a module from load_parent_k4) the earlier K4 is held
    to the same output and timed in turns with the fused kernel (parent,
    fused, fused, parent). Returns the kernels-line numbers of the
    pipeline block. `timer` is cuda_ms on the card; the tests rehearse
    on the CPU with another."""
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    out = {}
    for label, coeff, shape in (
            (f"pipeline block (8, 10, {block}) encode", gf.parity_matrix(),
             (ecb.DEFAULT_BATCH_WINDOWS, gf.DATA_SHARDS, block)),
            (f"recover rows=1 (1, 10, {block})",
             gf.shard_rows([0], present_for([0])),
             (1, gf.DATA_SHARDS, block))):
        x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen)
        bitmat = device_bitmatrix(coeff, dev)
        consts = device_consts(coeff, dev)
        rows, k = coeff.shape
        got = gf2_bitmatrix_transform(bitmat, x)
        check(abs_err(got, gf256_transform(consts, x)) == 0,
              f"K4 differs from K1 at {label}")
        del got
        ms = timer(lambda: gf2_bitmatrix_transform(bitmat, x), 50)
        b2b_ms = timer(lambda: gf2_bitmatrix_transform(bitmat, x), 50,
                       spin=False)
        k1_ms = timer(lambda: gf256_transform(consts, x), 50)
        if parent is not None:
            check(abs_err(parent.gf2_bitmatrix_transform(bitmat, x),
                          gf2_bitmatrix_transform(bitmat, x)) == 0,
                  f"the parent's K4 differs from the fused kernel at {label}")
            turns = {"parent": [], "fused": []}
            for name in ("parent", "fused", "fused", "parent"):
                fn = (parent if name == "parent" else gf256_mxu
                      ).gf2_bitmatrix_transform
                turns[name].append(timer(lambda: fn(bitmat, x), 20))
            print(f"  K4 {label} in turns: parent (unfused) "
                  f"{turns['parent'][0]:.4f}, {turns['parent'][1]:.4f} ms; "
                  f"fused {turns['fused'][0]:.4f}, {turns['fused'][1]:.4f} "
                  f"ms [{card}]")
        plain_ms = timer(
            lambda: gf2_bitmatrix_transform_reference(bitmat, x), 3)
        b = bound(rows, k, shape[0], shape[2])
        ks, ni = k4_instance(rows, k)
        padded_ms = (2 * 32 * ks * 32 * ni * shape[0] * shape[2]
                     / INT8_OPS_PER_S * 1e3)
        regs = k4_registers(report, rows, k)
        print(f"  K4 {label}: {ms:.4f} ms, one launch (device alone; back "
              f"to back with the host's calls {b2b_ms:.4f} ms); K1 "
              f"{k1_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} "
              f"bytes; int8 ops {b['ops_ms']:.4f} ms, {padded_ms:.4f} ms as "
              f"the instance pads them: K {32 * ks}, N {32 * ni}), share "
              f"{b['bound_ms'] / ms:.3f} (K1 {b['bound_ms'] / k1_ms:.3f}); "
              f"instance KS={ks} NI={ni}: {regs.get('registers')} "
              f"registers, spill stores {regs.get('spill_stores')} B, "
              f"spill loads {regs.get('spill_loads')} B [{card}]")
        if not out:
            out = {"ms": ms, "b2b_ms": b2b_ms, "plain_ms": plain_ms,
                   "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                   "k1_ms": k1_ms, **regs}
        del x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- K5: CRC32C of every row (phases 2 and 5) --------------------------------

# the lengths and edge rows of tests/test_crc32c_jax.py, its explicit blocks,
# and bench.py's (64, 1 MiB); then shapes the persistent grid treats apart:
# more rows than it has blocks, more rows than a grid's y dimension holds
# (the limit of the kernel it replaced), and one row long enough for stage
# 2 to carry its tile states in several chunks of 32
CRC_NS = (1, 2, 7, 64, 255, 256, 1024, 4096, 12345)
CRC_BLOCKS = (1, 2, 64, 256, 2048)
CRC_BENCH = (64, MIB)
CRC_MANY = (4096, 4096)
CRC_TALL = (65537, 16)
CRC_LONG = 128 * MIB
# the commit of the K5 that load_parent_k5 times beside this one
K5_PARENT = "1db9ba1"


def crc32c_cases(dev: torch.device, seed: int):
    """(name, (B, n) uint8 rows on `dev`, block or None, span or None,
    held to the plain version too) for phase 2. A span forces the
    kernel's span size (crc32c_cuda.launch_kernel) where the wrapper would
    pick another; rows of CRC_LONG bytes are held to the host CRC alone
    (the plain version's PowMat would take minutes to build)."""
    from seaweedfs_tpu_torch.ops.crc32c_cuda import SPANS
    rng = np.random.default_rng([seed, 5])
    for n in CRC_NS:
        yield (f"n={n}", torch.from_numpy(rng.integers(
            0, 256, (4, n), dtype=np.uint8)).to(dev), None, None, True)
    edge = np.stack([np.zeros(512, np.uint8), np.full(512, 0xFF, np.uint8),
                     np.eye(1, 512, 0, dtype=np.uint8)[0] * 0x80])
    yield "edge rows (zeros, 0xFF, one bit)", torch.from_numpy(edge).to(
        dev), None, None, True
    two = torch.from_numpy(rng.integers(0, 256, (2, 2048),
                                        dtype=np.uint8)).to(dev)
    for blk in CRC_BLOCKS:
        yield f"(2, 2048) block={blk}", two, blk, None, True
    wide = torch.from_numpy(rng.integers(0, 256, (3, 5000),
                                         dtype=np.uint8)).to(dev)
    yield "strided rows (3, 5000)[:, :4096]", wide[:, :4096], None, None, True
    for off in (1, 5, 15):
        yield (f"rows {off} bytes off a 16-byte boundary",
               wide[:, off:off + 4096], None, None, True)
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    yield f"bench shape {CRC_BENCH}", torch.randint(
        0, 256, CRC_BENCH, dtype=torch.uint8, device=dev,
        generator=gen), None, None, True
    for span in SPANS:
        for d in (-1, 1):
            yield (f"(3, {span + d}) in spans of {span}: one byte "
                   f"{'under' if d < 0 else 'over'} a span",
                   torch.from_numpy(rng.integers(
                       0, 256, (3, span + d), dtype=np.uint8)).to(dev),
                   None, span, True)
    many = torch.randint(0, 256, CRC_MANY, dtype=torch.uint8, device=dev,
                         generator=gen)
    yield f"{CRC_MANY}: more rows than blocks", many, None, None, True
    yield (f"{CRC_MANY} in spans of 64: more tiles than blocks", many, None,
           64, True)
    yield (f"{CRC_TALL}: more than 65,535 rows", torch.randint(
        0, 256, CRC_TALL, dtype=torch.uint8, device=dev, generator=gen),
        None, None, True)
    yield (f"(1, {CRC_LONG}): stage 2 carries several chunks",
           torch.randint(0, 256, (1, CRC_LONG), dtype=torch.uint8,
                         device=dev, generator=gen), None, None, False)


def phase_crc32c_vs_plain(dev: torch.device, seed: int) -> int:
    """K5 against its plain version and the port's host util/crc32c on
    every case of crc32c_cases; returns the rows that differ (0)."""
    from seaweedfs_tpu_torch.ops.crc32c_cuda import (crc32c_batch,
                                                     crc32c_batch_reference,
                                                     launch_kernel)
    from seaweedfs_tpu_torch.util.crc32c import crc32c
    mismatches = 0
    for name, rows, blk, span, plain in crc32c_cases(dev, seed):
        got = (crc32c_batch(rows) if span is None or dev.type != "cuda"
               else launch_kernel(rows, span=span))
        bad = 0
        if plain:
            bad += int((got != crc32c_batch_reference(rows, block=blk))
                       .sum().item())
        sync(dev)
        host = [crc32c(r.tobytes()) for r in rows.cpu().numpy()]
        bad += sum(int(a) != b for a, b in zip(got.cpu().tolist(), host))
        mismatches += bad
        print(f"  K5 crc32c_batch vs {'plain and ' if plain else ''}host: "
              f"{name}: {bad} mismatches")
        check(bad == 0, f"K5 differs from its plain version or the host "
              f"CRC: {name}")
        del got, rows
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return mismatches


def crc32c_bound(rows: int, n: int) -> dict:
    """Least time for the CRC32C of (rows, n) bytes: each byte read once
    and a uint32 written per row, over the HBM rate; or the GF(2)
    products of crc32c_jax.py as int8 operations over the int8 rate (the
    smaller here)."""
    nbytes = rows * n + 4 * rows
    blk = 256 if n % 256 == 0 else 1
    ops = 2 * rows * n * 8 * 32 + 2 * rows * (n // blk) * 32 * 32
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "ops_ms": ops_ms}


# a K5 kernel in a mangled name: crc32c_tiles<slice, mode, fold>, the
# carry, or the earlier kernel's segments and fold
K5_KERNEL = re.compile(r"\dcrc32c_([a-z]+)(?:ILi(\d+)ELi(\d+)ELb(\d)E)?")


def k5_kernels(report: dict, smem: dict | None = None) -> dict:
    """name -> ptxas facts of every K5 kernel in a ptxas `report`, with its
    static shared memory from `smem` (ptxas_smem) where given."""
    out = {}
    for fn, facts in report.items():
        m = K5_KERNEL.search(fn)
        if m:
            name = m.group(1) + (f"<{m.group(2)},{m.group(3)},{m.group(4)}>"
                                 if m.group(2) else "")
            out[name] = dict(facts, **({"static_smem": smem.get(fn)}
                                       if smem is not None else {}))
    return out


def ptxas_smem(log: str) -> dict:
    """name -> static shared memory bytes of every entry function in an
    nvcc -Xptxas=-v log (0 where ptxas reports none)."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = 0
            continue
        m = re.search(r"(\d+) bytes smem", line)
        if m and fn is not None:
            out[fn] = int(m.group(1))
    return out


def k5_parent_sources(dest: str) -> str | None:
    """Write the K5 of commit K5_PARENT (its ops/crc32c_cuda.py and
    ops/csrc/crc32c.cu, from git show) into `dest`; returns dest, or None
    where this checkout has no git history to take them from."""
    os.makedirs(dest, exist_ok=True)
    try:
        for path in ("crc32c_cuda.py", "csrc/crc32c.cu"):
            src = subprocess.run(
                ["git", "-C", ROOT, "show",
                 f"{K5_PARENT}:seaweedfs_tpu_torch/ops/{path}"],
                capture_output=True, check=True, timeout=60).stdout
            with open(os.path.join(dest, os.path.basename(path)), "wb") as f:
                f.write(src)
    except (OSError, subprocess.SubprocessError):
        return None
    return dest


def load_parent_k5(parent: str):
    """The wrapper module of an earlier K5 from `parent`, a directory
    holding that commit's ops/crc32c_cuda.py and ops/csrc/crc32c.cu
    (k5_parent_sources): both are copied into the package as
    crc32c_cuda_parent.py and csrc/crc32c_parent.cu, the module is
    imported and built, and the copies are removed again (the built
    library stays in _build/). The module's `ptxas` holds the build's
    register report, `smem` its shared memory."""
    import importlib
    ops = os.path.dirname(_build.CSRC)
    py = os.path.join(ops, "crc32c_cuda_parent.py")
    cu = os.path.join(_build.CSRC, "crc32c_parent.cu")
    with open(os.path.join(parent, "crc32c_cuda.py")) as f:
        src = f.read().replace('_build.load("crc32c")',
                               '_build.load("crc32c_parent")')
    try:
        with open(py, "w") as f:
            f.write(src)
        shutil.copy(os.path.join(parent, "crc32c.cu"), cu)
        mod = importlib.import_module(
            "seaweedfs_tpu_torch.ops.crc32c_cuda_parent")
        log = _build.build_all(("crc32c_parent",))["crc32c_parent"]
        _build.load("crc32c_parent")
    finally:
        for path in (py, cu):
            if os.path.exists(path):
                os.remove(path)
    mod.ptxas, mod.smem = ptxas_report(log), ptxas_smem(log)
    return mod


# the split's variants (csrc/crc32c.cu swtpu_crc32c_split), by number
K5_VARIANTS = ("kernel", "constant lookups", "loads alone", "no fold",
               "slicing-by-8, 16 copies")


def split_crc32c(x: torch.Tensor, timer=cuda_ms) -> dict:
    """K5's device time at the rows x, split: stage 1 alone in each of the
    split's variants (the kernel; its lookups from one constant address,
    so no index arithmetic and no bank can conflict; the loads alone; no
    fold; slicing-by-8 over 16 copies of 8 tables), stage 2 alone, stage
    1 and its loads alone with each thread's span read contiguously (not
    woven), the whole kernel in every span size, and torch's sum of the
    same bytes as float32 (a yardstick of the card's read rate, not the
    same function). The slicing-by-8
    variant, the contiguous spans and every span size are held equal to
    the kernel first."""
    from seaweedfs_tpu_torch.ops import crc32c_cuda as k5
    want = k5.launch_kernel(x)
    for variant in (0, 4):
        check(torch.equal(k5.launch_kernel(x, variant=variant), want),
              f"K5 variant {K5_VARIANTS[variant]} differs from the kernel")
    for span in k5.SPANS:
        check(torch.equal(k5.launch_kernel(x, span=span), want),
              f"K5 in spans of {span} differs from the kernel")
    out = {f"stage 1, {name}": timer(
        lambda v=v: k5.launch_kernel(x, variant=v, stages=1), 50)
        for v, name in enumerate(K5_VARIANTS)}
    out["stage 2"] = timer(lambda: k5.launch_kernel(x, variant=0, stages=2),
                           50)
    check(torch.equal(k5.launch_kernel(x, woven=False), want),
          "K5 with contiguous spans differs from the kernel")
    out["stage 1, spans read contiguously"] = timer(
        lambda: k5.launch_kernel(x, stages=1, woven=False), 50)
    out["stage 1, loads alone, contiguously"] = timer(
        lambda: k5.launch_kernel(x, variant=2, stages=1, woven=False), 50)
    for span in k5.SPANS:
        out[f"span {span}"] = timer(
            lambda span=span: k5.launch_kernel(x, span=span), 50)
    # not the same function, so no library_ms: a yardstick of the rate at
    # which one PyTorch call reads the same bytes
    words = x.view(torch.float32)
    out["torch sum of the same bytes"] = timer(lambda: words.sum(), 50)
    return out


def time_crc32c(dev: torch.device, seed: int, card: str, report: dict,
                timer=cuda_ms, parent=None, smem: dict | None = None
                ) -> dict:
    """bench.py's CRC path (its only caller in the JAX package) on K5:
    the (64, 1 MiB) rows from `seed`, every row held to the host CRC, with
    the launch count read around that one call; then K5's time (device
    alone and back to back), the plain version's, the bound and its
    share, on the card the split (split_crc32c), and each kernel's
    registers, spills and shared memory from the ptxas `report` and
    `smem` (ptxas_smem). With `parent` (a module from load_parent_k5) the
    earlier K5 is held to the same output bit for bit and timed in turns
    with this one (parent, new, new, parent). `timer` is cuda_ms on the
    card; the tests rehearse on the CPU with another."""
    from seaweedfs_tpu_torch.ops import crc32c_cuda
    from seaweedfs_tpu_torch.util.crc32c import crc32c
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    rows, n = CRC_BENCH
    x = torch.randint(0, 256, (rows, n), dtype=torch.uint8, device=dev,
                      generator=gen)
    crc32c_cuda.launches = 0
    got = crc32c_cuda.crc32c_batch(x)
    sync(dev)
    launches = crc32c_cuda.launches
    host = [crc32c(r.tobytes()) for r in x.cpu().numpy()]
    check(got.cpu().tolist() == host, "K5 differs from the host CRC at "
          "bench.py's shape")
    ms = timer(lambda: crc32c_cuda.crc32c_batch(x), 50)
    b2b_ms = timer(lambda: crc32c_cuda.crc32c_batch(x), 50, spin=False)
    plain_ms = timer(lambda: crc32c_cuda.crc32c_batch_reference(x), 3)
    b = crc32c_bound(rows, n)
    regs = k5_kernels(report, smem)
    out = {"launches": launches, "ms": ms, "b2b_ms": b2b_ms,
           "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
           "bound_by": b["bound_by"], "registers": regs}
    print(f"  K5 crc32c_batch ({rows}, {n}) (bench.py's shape): "
          f"{launches} launch in bench.py's path, every row equal to the "
          f"host CRC; {ms:.4f} ms (device alone; back to back with the "
          f"host's calls {b2b_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} bytes; "
          f"the GF(2) products as int8 ops {b['ops_ms']:.4f} ms), share "
          f"{b['bound_ms'] / ms:.3f}; {rows * n / ms / 1e6:.1f} GB/s [{card}]")
    if dev.type == "cuda":
        sms = crc32c_cuda.sm_count(dev)
        span = crc32c_cuda.pick_span(rows, n, sms)
        out["split"] = split_crc32c(x, timer)
        out["smem_bytes"] = crc32c_cuda.smem_bytes()
        print(f"  K5 split at ({rows}, {n}): span {span}, "
              f"{crc32c_cuda.tile_count(rows, n, span)} tiles on {sms} SMs; "
              + "; ".join(f"{k} {v:.4f} ms (share {b['bound_ms'] / v:.3f})"
                          for k, v in out["split"].items()) + f" [{card}]")
        print(f"  K5 kernels (ptxas): {regs}; dynamic shared memory "
              f"{out['smem_bytes']} B a stage-1 block [{card}]")
    if parent is not None:
        check(torch.equal(parent.crc32c_batch(x), got),
              "the parent's K5 differs from this one")
        turns = {"parent": [], "new": []}
        for name in ("parent", "new", "new", "parent"):
            fn = (parent if name == "parent" else crc32c_cuda).crc32c_batch
            turns[name].append(timer(lambda fn=fn: fn(x), 20))
        out["turns"] = turns
        print(f"  K5 ({rows}, {n}) in turns with commit {K5_PARENT}'s "
              f"kernel: parent {turns['parent'][0]:.4f}, "
              f"{turns['parent'][1]:.4f} ms; new {turns['new'][0]:.4f}, "
              f"{turns['new'][1]:.4f} ms; parent kernels (ptxas) "
              f"{k5_kernels(parent.ptxas, parent.smem)}, no dynamic shared "
              f"memory [{card}]")
    del x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- phase 6: the mesh path --------------------------------------------------

MESH_LOST = (0, 11, 12, 13)


def phase_mesh(dev: torch.device, seed: int, volumes: int, n: int) -> dict:
    """parallel/mesh.py on the current process group: full_cycle_step on
    (volumes, 10, n) made from `seed`, then batched_verify clean and after
    one flipped byte of parity row 12 of volume 1. The launch counts are
    read right after those calls; then each result is held against the
    plain version. Returns the counts and the tensors the timing reuses."""
    mesh = pmesh.make_mesh()
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    data = torch.randint(0, 256, (volumes, gf.DATA_SHARDS, n),
                         dtype=torch.uint8, device=dev, generator=gen)
    flip = (1, 12, n // 2)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = (gf256_cuda.launches, gf256_cuda.stacked_launches)
    per_call = []
    t0 = time.perf_counter()
    encoded, rebuilt = pmesh.full_cycle_step(mesh, data, lost_rows=MESH_LOST)
    sync(dev)
    t1 = time.perf_counter()
    per_call.append(gf256_cuda.stacked_launches - before[1])
    clean = pmesh.batched_verify(mesh, encoded).tolist()
    t2 = time.perf_counter()
    per_call.append(gf256_cuda.stacked_launches - before[1] - sum(per_call))
    encoded[flip] ^= 0x01
    flipped = pmesh.batched_verify(mesh, encoded).tolist()
    encoded[flip] ^= 0x01
    sync(dev)
    per_call.append(gf256_cuda.stacked_launches - before[1] - sum(per_call))
    seen = {"seconds": (t1 - t0, t2 - t1, time.perf_counter() - t2),
            "launches": gf256_cuda.launches - before[0],
            "stacked_launches": gf256_cuda.stacked_launches - before[1],
            "per_call": per_call, "mesh": tuple(mesh.shape)}
    if dev.type == "cuda":
        seen["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    parity = device_consts(gf.parity_matrix(), dev)
    use = present_for(list(MESH_LOST))
    rebuild = device_consts(gf.shard_rows(list(MESH_LOST), use), dev)
    err = abs_err(encoded[:, :gf.DATA_SHARDS], data)
    want = gf256_stacked_transform_reference(parity, data)
    err = max(err, abs_err(encoded[:, gf.DATA_SHARDS:], want))
    want_bad = (want != encoded[:, gf.DATA_SHARDS:]).sum(dim=(1, 2)).tolist()
    del want
    survivors = encoded[:, use]
    want = gf256_stacked_transform_reference(rebuild, survivors)
    err = max(err, abs_err(rebuilt, want))
    check(err == 0, f"mesh path differs from the plain version by {err}")
    check(torch.equal(rebuilt, encoded[:, list(MESH_LOST)]),
          f"full_cycle_step did not restore shards {MESH_LOST}")
    del want
    want_flipped = [0] * volumes
    want_flipped[flip[0]] = 1
    check(clean == want_bad == [0] * volumes,
          f"clean batched_verify {clean}, plain version {want_bad}")
    check(flipped == want_flipped,
          f"batched_verify after one flipped parity byte: {flipped}")
    peak = (f"{seen['peak_bytes']} bytes" if "peak_bytes" in seen
            else "not measured")
    print(f"  mesh {seen['mesh']} ('vol','shard'): full_cycle_step on "
          f"({volumes}, 10, {n}) lost {MESH_LOST}, batched_verify "
          f"{clean} then {flipped} after one flip; host seconds (first "
          f"calls: NCCL and DTensor set-up included) full_cycle_step "
          f"{seen['seconds'][0]:.4f}, verify {seen['seconds'][1]:.4f}, "
          f"verify {seen['seconds'][2]:.4f}; every result equals the plain "
          f"version "
          f"(max_abs_err {err}); peak device memory in those calls {peak}")
    seen.update(max_abs_err=err, data=data, encoded=encoded,
                survivors=survivors, parity=parity, rebuild=rebuild,
                device_mesh=mesh)
    return seen


# the profiler's activity types that occupy the device itself; runtime
# calls, annotations and flow events are the host's side of them
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(events) -> dict:
    """events: (activity_type, start_ns, end_ns, name) of a trace. Over the
    device activities alone: the union of their spans (busy), the device
    window from the first one's start to the last one's end, the idle
    share of that window, and the time and count by name."""
    spans = sorted((start, end, name) for kind, start, end, name in events
                   if kind in DEVICE_ACTIVITIES)
    busy, reach, by_name = 0, None, {}
    for start, end, name in spans:
        total, count = by_name.get(name, (0, 0))
        by_name[name] = (total + end - start, count + 1)
        if reach is None or start >= reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    window = reach - spans[0][0] if spans else 0
    return {"busy_ns": busy, "window_ns": window,
            "idle_share": 1 - busy / window if window > 0 else None,
            "by_name": by_name}


def trace_events(prof) -> list[tuple]:
    """(category, start_ns, end_ns, name) of every complete event in a
    finished torch.profiler trace, read back from its Chrome trace (the
    category there is the activity type on every torch release; the
    Python event objects do not carry it on all of them)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    path = os.path.join(WORK_DIR, "trace.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        shutil.rmtree(WORK_DIR, ignore_errors=True)
    return [(e.get("cat"), round(float(e["ts"]) * 1e3),
             round((float(e["ts"]) + float(e["dur"])) * 1e3), e.get("name"))
            for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and "dur" in e]


def time_mesh_step(mesh, data: torch.Tensor, dev: torch.device) -> None:
    """Host seconds of full_cycle_step once its set-up is done, and, from
    a torch.profiler trace of one more call, the device's busy time by
    kernel and copy and its idle share of the device window."""
    from torch.profiler import ProfilerActivity, profile

    def step():
        pmesh.full_cycle_step(mesh, data, lost_rows=MESH_LOST)
        sync(dev)

    step()
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    events = trace_events(prof)
    d = device_busy(events)
    idle = (f"{d['idle_share']:.4f}" if d["idle_share"] is not None
            else "not measured (the trace shows no device activity)")
    print(f"  full_cycle_step after set-up: {wall:.4f} s host; traced call: "
          f"device busy {d['busy_ns'] / 1e6:.4f} ms of a "
          f"{d['window_ns'] / 1e6:.4f} ms device window (first to last "
          f"kernel or copy), idle share {idle}; activity types "
          f"{sorted({e[0] for e in events})}")
    for name, (total, count) in sorted(d["by_name"].items(),
                                       key=lambda kv: -kv[1][0])[:6]:
        print(f"    device {total / 1e6:9.4f} ms x{count}: {name[:90]}")


def time_mesh_blocks(seen: dict, dev: torch.device, card: str) -> dict:
    """The stacked entry at the rank's encode block (parity into the
    strided rows of the encoded block) and rebuild block; returns the
    encode block's kernels-line numbers."""
    data, survivors = seen["data"], seen["survivors"]
    out = seen["encoded"][:, gf.DATA_SHARDS:]
    parity, rebuild = seen["parity"], seen["rebuild"]
    bsz, k, n = data.shape
    def encode():
        gf256_stacked_transform(parity, data, out=out)

    def rebuild_block():
        gf256_stacked_transform(rebuild, survivors)

    plain_ms = cuda_ms(lambda: gf256_stacked_transform_reference(
        parity, data, out=out), 2)
    t = report_timing(f"mesh encode block ({bsz}, {k}, {n}) -> (.., 4, ..)"
                      f" out=[:, 10:]", cuda_ms(encode, 10),
                      cuda_ms(encode, 10, spin=False), plain_ms,
                      bound(4, k, bsz, n), dev, card)
    plain_ms = cuda_ms(lambda: gf256_stacked_transform_reference(
        rebuild, survivors), 2)
    report_timing(f"mesh rebuild block ({bsz}, {k}, {n}) lost {MESH_LOST}",
                  cuda_ms(rebuild_block, 10),
                  cuda_ms(rebuild_block, 10, spin=False), plain_ms,
                  bound(4, k, bsz, n), dev, card)
    return t


# -- phase 7: the store tier ---------------------------------------------------

# scratch space for the store phase, inside the checkout (git-ignored);
# apart from WORK_DIR, which trace_events empties
STORE_DIR = os.path.join(ROOT, ".smoke_store")
STORE_VID = 1
# the volume server's -cache.mem default (seaweedfs_tpu/cli.py:251)
NEEDLE_CACHE_BYTES = 32 << 20
# the window of /admin/ec/verify's windowMB=1 default
VERIFY_WINDOW = MIB
SCRUB_SHARD = 12
# the larger needles' size range: up to the filer's -chunkSizeMB 32 chunks
# (seaweedfs_tpu/cli.py:311)
LARGE_NEEDLE = (MIB, 32 * MIB)
# size classes of the recovers pass C samples against the plain version
RECOVER_CLASSES = ((1, 4096), (4096, 64 << 10), (64 << 10, MIB),
                   (MIB, MIB + 1))


def store_needle_specs(seed: int, target: int):
    """Yield (nid, cookie, data, name, mime) until the records' bytes pass
    `target`: three of every four needles are uniform in 1-64 KiB (the
    small-file end, where `benchmark -size` defaults to 1 KiB), the
    fourth uniform in LARGE_NEEDLE."""
    rng = np.random.default_rng(seed)
    total, nid = 8, 0
    while total < target:
        nid += 1
        lo, hi = (LARGE_NEEDLE if nid % 4 == 0 else (1 << 10, 64 << 10))
        size = int(rng.integers(lo, hi + 1))
        name = f"obj-{nid:06d}.bin".encode()
        mime = b"application/octet-stream" if nid % 2 else b"image/jpeg"
        # the needle's size field: data length, data, flags, name, mime
        total += st.actual_size(4 + size + 1 + 1 + len(name) + 1 + len(mime),
                                st.CURRENT_VERSION)
        yield (nid, int(rng.integers(1, 1 << 32)), rng.bytes(size), name,
               mime)


def percentile_ms(lat: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(lat) * 1e3, q)) if lat else 0.0


def read_pass(store, specs: dict, order: list[int]) -> list[float]:
    """Read every needle of `order` through Store.read_needle and hold
    its bytes, name, mime and stored CRC to what was written; returns
    each read's seconds."""
    from seaweedfs_tpu_torch.util import crc32c
    lat = []
    for nid in order:
        cookie, data, name, mime = specs[nid]
        t0 = time.perf_counter()
        n = store.read_needle(STORE_VID, nid, cookie)
        lat.append(time.perf_counter() - t0)
        check(n.data == data and n.name == name and n.mime == mime,
              f"needle {nid}: read back differs from what was written")
        check(n.checksum == crc32c.checksum_value(data),
              f"needle {nid}: stored CRC differs from the data's")
    return lat


def lost_intervals(base: str, lost: list[int], large_block: int,
                   small_block: int, order: list[int]) -> list[tuple]:
    """(nid, shard, shard offset, size) of every interval of the needles
    in `order` that lies on a lost shard, in the order reads recover
    them: located from the .ecx with locate_data, as
    EcVolume.read_needle locates them."""
    from seaweedfs_tpu_torch.ec.locate import locate_data
    from seaweedfs_tpu_torch.storage.needle_map import walk_index_blob
    with open(base + ".ecx", "rb") as f:
        index = {key: (off, size) for key, off, size in walk_index_blob(f.read())}
    present = next(s for s in range(gf.TOTAL_SHARDS) if s not in lost)
    dat_size = gf.DATA_SHARDS * os.path.getsize(base + pl.to_ext(present))
    out = []
    for nid in order:
        off, size = index[nid]
        for iv in locate_data(large_block, small_block, dat_size, off,
                              st.actual_size(size, st.CURRENT_VERSION)):
            sid, soff = iv.to_shard_and_offset(large_block, small_block)
            if sid in lost:
                out.append((nid, sid, soff, iv.size))
    return out


def split_at(intervals: list[tuple], threshold: int) -> tuple[int, int]:
    """(intervals under the threshold, intervals at or above it): the
    host CpuEncoder's recovers and the card's."""
    big = sum(1 for iv in intervals if iv[3] >= threshold)
    return len(intervals) - big, big


def check_cache_cold(store, specs: dict, intervals: list[tuple],
                     vid: int = STORE_VID) -> None:
    """Neither the needle cache nor the recover cache holds anything a
    degraded read of this volume could be served from."""
    nc, rc = store.needle_cache, store.ec_recover_cache
    hot = [nid for nid in specs
           if nc is not None and nc._lru.peek_contains((vid, nid))]
    hot += [iv for iv in intervals if rc is not None
            and rc.peek_contains((vid,) + iv[1:])]
    check(hot == [], f"caches still hold {len(hot)} entries of volume "
          f"{vid} before the degraded pass, first {hot[:3]}")


def check_store_counts(seen: dict, path: str = "store path") -> int:
    """Each step's kernel launches equal what its geometry and dispatch
    counts say; returns the launches of the path."""
    for step, want in seen["expected"].items():
        got = seen["launches"][step]
        check(got == want, f"{path}, {step}: {got} kernel launches, "
              f"expected {want}")
    return sum(seen["launches"].values())


class RecordLaunches:
    """Stands in for encoder_torch's gf256_transform during pass C: calls
    the wrapper (which launches and counts), records every launch's input
    shape, and keeps inputs and outputs of the chosen launch indices."""

    def __init__(self, keep: set[int]):
        self.keep = keep
        self.shapes: list[tuple] = []
        self.kept: dict[int, tuple] = {}

    def __call__(self, consts, x):
        out = gf256_transform(consts, x)
        i = len(self.shapes)
        self.shapes.append(tuple(x.shape))
        if i in self.keep:
            self.kept[i] = (consts, x.clone(), out.clone())
        return out


def sample_by_class(intervals: list[tuple], seed: int, per_class: int = 3
                    ) -> set[int]:
    """Seeded launch indices: up to per_class of each RECOVER_CLASSES."""
    rng = np.random.default_rng(seed)
    keep = set()
    for lo, hi in RECOVER_CLASSES:
        idx = [i for i, iv in enumerate(intervals) if lo <= iv[3] < hi]
        if idx:
            keep.update(int(i) for i in rng.choice(
                idx, min(per_class, len(idx)), replace=False))
    return keep


def flip_byte(path: str, offset: int) -> None:
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x01]))


def phase_store(dev: torch.device, seed: int, target: int,
                card: str = "") -> dict:
    """The store tier as a volume server drives it, on one volume of
    `target` bytes: write needles, EC-generate, read intact (A), verify
    parity, scrub a flipped byte, read with 4 shards lost at the default
    recover threshold (B) and with every recover on the device (C),
    rebuild, verify and read again. Returns the launch counts and what
    the geometry and the reports say they must be (check_store_counts)."""
    import asyncio

    from seaweedfs_tpu_torch.ec.scrub import Scrubber
    from seaweedfs_tpu_torch.ec import encoder_torch
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    tag = f"[{card}]" if card else ""
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    os.makedirs(STORE_DIR)
    launches, expected, timing = {}, {}, {}

    def counted(step: str, fn):
        gf256_cuda.launches = 0
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = gf256_cuda.launches
        return out

    store = Store([STORE_DIR], needle_cache_bytes=NEEDLE_CACHE_BYTES)
    try:
        # -- write
        store.add_volume(STORE_VID)
        specs, order = {}, []
        t0 = time.perf_counter()
        written = 0
        for nid, cookie, data, name, mime in store_needle_specs(seed, target):
            store.write_needle(STORE_VID, Needle(
                cookie=cookie, id=nid, data=data, name=name, mime=mime))
            specs[nid] = (cookie, data, name, mime)
            order.append(nid)
            written += len(data)
        write_s = time.perf_counter() - t0
        v = store.volumes[STORE_VID]
        dat_size = v.data_size()
        base = v.file_name()
        print(f"  write: {len(order)} needles, {written} needle bytes, "
              f".dat {dat_size} bytes in {write_s:.3f} s = "
              f"{written / write_s / 1e6:.1f} MB/s through "
              f"Store.write_needle {tag}")

        # -- generate, as /admin/ec/generate, then mount as ec.encode
        store.mark_readonly(STORE_VID)
        enc_stats: dict = {}

        def generate():
            pl.encode_volume(base, large_block=store.ec_large_block,
                             small_block=store.ec_small_block,
                             stats=enc_stats)
            pl.write_sorted_file_from_idx(base)
        counted("encode", generate)
        expected["encode"] = enc_stats["dispatches"]
        store.unmount_volume(STORE_VID)
        store.delete_volume(STORE_VID)
        mounted = store.mount_ec_shards("", STORE_VID)
        check(mounted == list(range(gf.TOTAL_SHARDS)),
              f"mounted shards {mounted}")
        ev = store.ec_volumes[STORE_VID]
        threshold = ev.small_recover_bytes
        n_windows = -(-ev.shard_size // VERIFY_WINDOW)
        print(f"  encode_volume + write_sorted_file_from_idx: "
              f"{timing['encode']:.3f} s, {enc_stats['dispatches']} "
              f"dispatches; mounted 14 shards of {ev.shard_size} bytes "
              f"({n_windows} verify windows of 1 MiB) {tag}")

        # -- pass A: intact reads
        lat_a = counted("pass A", lambda: read_pass(store, specs, order))
        expected["pass A"] = 0

        # -- verify, as /admin/ec/verify windowMB=1
        rep = counted("verify", lambda: ev.verify_parity(VERIFY_WINDOW))
        check(rep["bad_windows"] == [] and rep["missing_shards"] == [],
              f"clean volume: verify_parity reported {rep}")
        check(rep["dispatches"] == math.ceil(
            n_windows / ecb.DEFAULT_BATCH_WINDOWS),
            f"verify dispatches {rep['dispatches']} for {n_windows} windows")
        expected["verify"] = rep["dispatches"]

        # -- scrub: one flipped byte of .ec12
        flip_w = n_windows // 3
        flip_at = flip_w * VERIFY_WINDOW + 777
        flip_byte(base + pl.to_ext(SCRUB_SHARD), flip_at)
        rep = counted("verify flipped",
                      lambda: ev.verify_parity(VERIFY_WINDOW))
        check(rep["bad_windows"] == [flip_w * VERIFY_WINDOW],
              f"one flipped byte in window {flip_w}: verify_parity "
              f"reported {rep['bad_windows']}")
        expected["verify flipped"] = rep["dispatches"]
        scrubber = Scrubber(store, mbps=0.0)
        cycle = counted("scrub", lambda: asyncio.run(scrubber.run_cycle()))
        found = [(w["offset"], w["shards"]) for w in cycle["corrupt_windows"]]
        check(found == [(flip_w * VERIFY_WINDOW, [SCRUB_SHARD])]
              and cycle["errors"] == [],
              f"scrub cycle found {found} (errors {cycle['errors']}), "
              f"expected window {flip_w} localized to shard {SCRUB_SHARD}")
        # 14 hypotheses, each a reconstruct and a re-verify
        expected["scrub"] = cycle["dispatches"] + 2 * gf.TOTAL_SHARDS
        flip_byte(base + pl.to_ext(SCRUB_SHARD), flip_at)
        print(f"  verify_parity: clean, {expected['verify']} dispatches in "
              f"{timing['verify']:.3f} s; after a flipped byte of .ec12 "
              f"only window {flip_w} in {timing['verify flipped']:.3f} s; "
              f"Scrubber.run_cycle (mbps=0, {scrubber.batch_windows} "
              f"windows a block): {cycle['dispatches']} dispatches, window "
              f"{flip_w} localized to shard {SCRUB_SHARD}, "
              f"{timing['scrub']:.3f} s {tag}")

        # -- pass B: 4 lost shards, the default threshold
        store.unmount_ec_shards(STORE_VID, LOST)
        for sid in LOST:
            os.remove(base + pl.to_ext(sid))
        ivs = lost_intervals(base, LOST, store.ec_large_block,
                             store.ec_small_block, order)
        check_cache_cold(store, specs, ivs)
        host_n, card_n = split_at(ivs, threshold)
        lat_b = counted("pass B", lambda: read_pass(store, specs, order))
        expected["pass B"] = card_n
        print(f"  pass B: {len(ivs)} intervals on lost shards {LOST}: "
              f"{host_n} under the {threshold}-byte threshold (host "
              f"CpuEncoder), {card_n} at or above it (the card) {tag}")
        trace_store_reads(store, specs, order, dev, card)

        # -- pass C: every recover on the card
        store_c = Store([STORE_DIR], needle_cache_bytes=NEEDLE_CACHE_BYTES,
                        ec_small_recover_bytes=0)
        check(sorted(store_c.ec_volumes) == [STORE_VID]
              and sorted(store_c.ec_volumes[STORE_VID].shards)
              == [s for s in range(gf.TOTAL_SHARDS) if s not in LOST],
              "second store did not mount the degraded EC volume")
        recorder = RecordLaunches(sample_by_class(ivs, seed))
        encoder_torch.gf256_transform = recorder
        try:
            lat_c = counted("pass C",
                            lambda: read_pass(store_c, specs, order))
        finally:
            encoder_torch.gf256_transform = gf256_transform
            store_c.close()
        expected["pass C"] = len(ivs)
        want_shapes = [(1, gf.DATA_SHARDS, iv[3]) for iv in ivs]
        check(recorder.shapes == want_shapes,
              "pass C launches differ from the lost-shard intervals in "
              "number, order or shape")
        max_err = 0
        for i in sorted(recorder.kept):
            consts, x, out = recorder.kept[i]
            max_err = max(max_err, abs_err(
                out, gf256_transform_reference(consts, x)))
        check(max_err == 0, f"pass C recovers differ from the plain "
              f"version by {max_err}")
        sizes = sorted({recorder.kept[i][1].shape[2] for i in recorder.kept})
        print(f"  pass C (ec_small_recover_bytes=0): {len(ivs)} launches "
              f"at (1, 10, n), n {min(iv[3] for iv in ivs)}..."
              f"{max(iv[3] for iv in ivs)}; {len(recorder.kept)} sampled "
              f"launches (n in {sizes}) equal the plain version on the "
              f"card, max_abs_err {max_err} {tag}")

        # -- rebuild, remount, verify, read intact again
        reb_stats: dict = {}
        rebuilt = counted("rebuild", lambda: pl.rebuild_ec_files(
            base, stats=reb_stats))
        check(rebuilt == LOST, f"rebuilt {rebuilt}, lost {LOST}")
        expected["rebuild"] = reb_stats["dispatches"]
        check(store.mount_ec_shards("", STORE_VID)
              == list(range(gf.TOTAL_SHARDS)), "remount after rebuild")
        ev = store.ec_volumes[STORE_VID]
        rep = counted("verify rebuilt",
                      lambda: ev.verify_parity(VERIFY_WINDOW))
        check(rep["bad_windows"] == [] and rep["missing_shards"] == [],
              f"rebuilt volume: verify_parity reported {rep}")
        expected["verify rebuilt"] = rep["dispatches"]
        lat_a2 = counted("pass A rebuilt",
                         lambda: read_pass(store, specs, order))
        expected["pass A rebuilt"] = 0
        print(f"  rebuild_ec_files of {LOST}: {timing['rebuild']:.3f} s; "
              f"remounted, verify_parity clean in "
              f"{timing['verify rebuilt']:.3f} s {tag}")
        for name, lat in (("A", lat_a), ("B", lat_b), ("C", lat_c),
                          ("A after rebuild", lat_a2)):
            print(f"  pass {name}: {len(lat)} needles in {sum(lat):.3f} s = "
                  f"{len(lat) / sum(lat):.1f} needles/s, read latency p50 "
                  f"{percentile_ms(lat, 50):.4f} ms, p99 "
                  f"{percentile_ms(lat, 99):.4f} ms {tag}")
        print(f"  store path kernel launches per step: {launches}")
    finally:
        store.close()
        shutil.rmtree(STORE_DIR, ignore_errors=True)
    return {"launches": launches, "expected": expected, "timing": timing,
            "needles": len(order), "intervals": len(ivs),
            "split": (host_n, card_n), "max_abs_err": max_err}


def trace_store_reads(store, specs: dict, order: list[int],
                      dev: torch.device, card: str, count: int = 32) -> None:
    """A torch.profiler trace of pass B's first `count` reads, read again
    with the volume's cache entries dropped so each recovers as in pass
    B: the device's busy time and its idle share of the device window."""
    if dev.type != "cuda":
        return
    from torch.profiler import ProfilerActivity, profile
    store.drop_cached_volume(STORE_VID)
    store.ec_recover_cache.drop_volume(STORE_VID)
    part = order[:count]
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        read_pass(store, specs, part)
        sync(dev)
    wall = time.perf_counter() - t0
    d = device_busy(trace_events(prof))
    idle = (f"{d['idle_share']:.4f}" if d["idle_share"] is not None
            else "not measured (the trace shows no device activity)")
    print(f"  traced pass B reads of {len(part)} needles: {wall:.4f} s host; "
          f"device busy {d['busy_ns'] / 1e6:.4f} ms of a "
          f"{d['window_ns'] / 1e6:.4f} ms device window, idle share {idle} "
          f"[{card}]")
    for name, (total, n) in sorted(d["by_name"].items(),
                                   key=lambda kv: -kv[1][0])[:4]:
        print(f"    device {total / 1e6:9.4f} ms x{n}: {name[:90]}")


def time_recover_crossover(card: str, reps: int = 20) -> None:
    """Host seconds per recover of one lost row from 10 survivor
    intervals of 4 KiB, 64 KiB, 256 KiB and 1 MiB, as
    EcVolume._recover_interval runs it (pipeline._transform_buffers), on
    the host CpuEncoder and on the card."""
    from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
    rng = np.random.default_rng(7)
    rows = present_for(LOST)
    coeff = gf.cached_shard_rows((0,), tuple(rows))
    encoders = (("host CpuEncoder", CpuEncoder()),
                ("card", pl.get_encoder("gpu")))
    for size in (4 << 10, 64 << 10, 256 << 10, MIB):
        bufs = [rng.integers(0, 256, size, dtype=np.uint8) for _ in rows]
        ms = {}
        for name, enc in encoders:
            pl._transform_buffers(enc, coeff, bufs)
            t0 = time.perf_counter()
            for _ in range(reps):
                pl._transform_buffers(enc, coeff, bufs)
            ms[name] = (time.perf_counter() - t0) / reps * 1e3
        print(f"  recover of a {size}-byte interval: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f" per call [{card}]")


# -- phase 8: the volume server over HTTP -------------------------------------

# the server's store directory, inside the checkout (git-ignored)
SERVER_DIR = os.path.join(ROOT, ".smoke_server")
SERVER_VID = 1


def dead_master() -> str:
    """host:port where nothing listens: the server's heartbeats fail and
    retry, and everything is served locally."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def server_args(backend: str, directory: str = SERVER_DIR,
                master: str | None = None, cache_mb: int = 32) -> list[str]:
    """The port CLI's `volume` command line for phases 8, 9 and 11-14:
    port 0, the -cache.mem (unless `cache_mb` says otherwise) and
    -ec.smallrecover defaults written out, and an
    unpaced scrubber (-scrub.mbps 0: the default 8 MiB/s would take
    minutes over a 1 GiB volume; phase 7's Scrubber runs unpaced too).
    With no `master` the heartbeats go where nothing listens."""
    return ["volume", "-port", "0", "-dir", directory,
            "-master", master or dead_master(), "-ecBackend", backend,
            "-cache.mem", str(cache_mb), "-ec.smallrecover", str(MIB),
            "-scrub.mbps", "0", "-scrub.pausems", "0"]


def host_parity_matches(base: str, chunk: int = 4 * MIB) -> bool:
    """The 4 parity shard files equal the host CpuEncoder's parity of the
    10 data shard files, computed chunk by chunk: an oracle that does
    not touch the card."""
    from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
    enc = CpuEncoder()
    files = [open(base + pl.to_ext(s), "rb") for s in range(gf.TOTAL_SHARDS)]
    try:
        while True:
            rows = [f.read(chunk) for f in files]
            if not rows[0]:
                return all(r == b"" for r in rows)
            want = enc.encode(rows[:gf.DATA_SHARDS])[gf.DATA_SHARDS:]
            if any(w.tobytes() != r for w, r in
                   zip(want, rows[gf.DATA_SHARDS:])):
                return False
    finally:
        for f in files:
            f.close()


def phase_server(dev: torch.device, seed: int, target: int, card: str = "",
                 backend: str = "gpu", keep_dir: str | None = None) -> dict:
    """The volume server as its users drive it, over HTTP: start it with
    the port CLI's start-up coroutine, write the needles of phase 7's
    generator up to `target` bytes, /admin/ec/generate, read every needle
    intact (A) and with shards {0,3,7,9} lost (B), /admin/ec/rebuild,
    /admin/ec/verify clean and after one flipped byte of .ec12, and a
    forced /debug/scrub cycle that must localize it. With `keep_dir`, the
    sealed .dat and .idx are hard-linked there before the server drops
    them, for phase 9. Returns the launch counts and what the geometry
    and the reports say they must be, and the parity files' sha256."""
    import asyncio
    import aiohttp
    print(f"  aiohttp {aiohttp.__version__}")
    shutil.rmtree(SERVER_DIR, ignore_errors=True)
    os.makedirs(SERVER_DIR)
    try:
        return asyncio.run(_drive_server(dev, seed, target, card, backend,
                                         keep_dir))
    finally:
        shutil.rmtree(SERVER_DIR, ignore_errors=True)


async def _drive_server(dev: torch.device, seed: int, target: int,
                        card: str, backend: str,
                        keep_dir: str | None) -> dict:
    import aiohttp
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.util import crc32c

    tag = f"[{card}]" if card else ""
    launches, expected, timing = {}, {}, {}
    vid = SERVER_VID
    base = os.path.join(SERVER_DIR, str(vid))

    async def counted(step: str, coro):
        gf256_cuda.launches = 0
        t0 = time.perf_counter()
        out = await coro
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = gf256_cuda.launches
        return out

    vs, rec = await cli.start_volume(
        cli.build_parser().parse_args(server_args(backend)))
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
    url = f"http://{vs.url}"

    async def admin(path: str, **params) -> dict:
        async with http.post(url + path, params=params) as r:
            body = await r.json()
            check(r.status == 200, f"POST {path} {params}: {r.status} "
                  f"{body}")
            return body

    def fid(nid: int, cookie: int) -> str:
        return f"{vid},{nid:x}{cookie:08x}"

    async def read_all(order: list[int], specs: dict) -> list[float]:
        lat = []
        for nid in order:
            cookie, data, name, mime = specs[nid]
            t0 = time.perf_counter()
            async with http.get(f"{url}/{fid(nid, cookie)}") as r:
                body = await r.read()
                status, etag = r.status, r.headers.get("ETag")
            lat.append(time.perf_counter() - t0)
            check(status == 200 and body == data,
                  f"GET needle {nid}: status {status}, "
                  f"{len(body)} bytes, expected {len(data)}")
            check(etag == f'"{crc32c.crc32c(data) & 0xFFFFFFFF:08x}"',
                  f"GET needle {nid}: ETag {etag} is not the data's CRC")
        return lat

    try:
        # -- write over HTTP, then seal
        await admin("/admin/volume/allocate", volume=str(vid))
        specs, order, written = {}, [], 0
        t0 = time.perf_counter()
        for nid, cookie, data, name, mime in store_needle_specs(seed,
                                                                target):
            form = aiohttp.FormData()
            form.add_field("file", data, filename=name.decode(),
                           content_type=mime.decode())
            async with http.post(f"{url}/{fid(nid, cookie)}",
                                 data=form) as r:
                check(r.status == 201, f"POST needle {nid}: {r.status} "
                      f"{await r.text()}")
            specs[nid] = (cookie, data, name, mime)
            order.append(nid)
            written += len(data)
        timing["write"] = time.perf_counter() - t0
        await admin("/admin/volume/readonly", volume=str(vid))
        dat_size = os.path.getsize(base + ".dat")
        if keep_dir is not None:
            for ext in (".dat", ".idx"):
                os.link(base + ext, os.path.join(keep_dir, str(vid) + ext))
        print(f"  write: {len(order)} needles, {written} needle bytes, "
              f".dat {dat_size} bytes in {timing['write']:.3f} s = "
              f"{written / timing['write'] / 1e6:.1f} MB/s through POST "
              f"/<fid> (multipart) {tag}")

        # -- generate
        gen = await counted("generate",
                            admin("/admin/ec/generate", volume=str(vid)))
        want = math.ceil(gen["windows"] / ecb.DEFAULT_BATCH_WINDOWS)
        check(gen["dispatches"] == want,
              f"/admin/ec/generate: {gen['dispatches']} dispatches for "
              f"{gen['windows']} windows, expected {want}")
        expected["generate"] = want
        check(host_parity_matches(base),
              "parity shard files differ from the host CpuEncoder's")
        parity_sha = {sid: sha_file(base + pl.to_ext(sid))
                      for sid in range(gf.DATA_SHARDS, gf.TOTAL_SHARDS)}
        print(f"  /admin/ec/generate: {timing['generate']:.3f} s, "
              f"{gen['windows']} windows in {gen['dispatches']} "
              f"dispatches; parity files equal the host CpuEncoder's {tag}")

        # -- mount the 14 shards, drop the normal volume, read intact
        mounted = await admin("/admin/ec/mount", volume=str(vid))
        check(mounted["shards"] == list(range(gf.TOTAL_SHARDS)),
              f"mounted shards {mounted}")
        await admin("/admin/volume/delete", volume=str(vid))
        store = vs.store
        ev = store.ec_volumes[vid]
        lat_a = await counted("pass A", read_all(order, specs))
        expected["pass A"] = 0

        # -- lose shards {0,3,7,9}, cold caches, read degraded
        sha_lost = {sid: sha_file(base + pl.to_ext(sid)) for sid in LOST}
        lost = ",".join(map(str, LOST))
        await admin("/admin/ec/unmount", volume=str(vid), shards=lost)
        await admin("/admin/ec/delete_shards", volume=str(vid), shards=lost)
        check(not any(os.path.exists(base + pl.to_ext(s)) for s in LOST),
              "lost shard files still on disk")
        ivs = lost_intervals(base, LOST, store.ec_large_block,
                             store.ec_small_block, order)
        store.drop_cached_volume(vid)
        store.ec_recover_cache.drop_volume(vid)
        check_cache_cold(store, specs, ivs, vid)
        host_n, card_n = split_at(ivs, ev.small_recover_bytes)
        lat_b = await counted("pass B", read_all(order, specs))
        expected["pass B"] = card_n
        print(f"  pass B: {len(ivs)} intervals on lost shards {LOST}: "
              f"{host_n} under the {ev.small_recover_bytes}-byte threshold "
              f"(host CpuEncoder), {card_n} at or above it (the EC "
              f"engine) {tag}")

        # -- rebuild
        reb = await counted("rebuild",
                            admin("/admin/ec/rebuild", volume=str(vid)))
        check(reb["rebuilt"] == LOST, f"rebuilt {reb}, lost {LOST}")
        got_sha = {sid: sha_file(base + pl.to_ext(sid)) for sid in LOST}
        check(got_sha == sha_lost, "rebuilt shard files differ from the "
              "deleted ones (sha256)")
        n_windows = -(-ev.shard_size // VERIFY_WINDOW)
        expected["rebuild"] = math.ceil(n_windows /
                                        ecb.DEFAULT_BATCH_WINDOWS)
        mounted = await admin("/admin/ec/mount", volume=str(vid))
        check(mounted["shards"] == list(range(gf.TOTAL_SHARDS)),
              f"remounted shards {mounted}")
        print(f"  /admin/ec/rebuild of {LOST}: {timing['rebuild']:.3f} s, "
              f"sha256-equal to the deleted files {tag}")

        # -- verify clean, then one flipped byte of .ec12, then scrub
        rep = await counted("verify", admin(
            "/admin/ec/verify", volume=str(vid), windowMB="1"))
        check(rep["bad_windows"] == [] and rep["missing_shards"] == [],
              f"clean volume: /admin/ec/verify reported {rep}")
        check(rep["dispatches"] == expected["rebuild"],
              f"verify dispatches {rep['dispatches']} for {n_windows} "
              f"windows")
        expected["verify"] = rep["dispatches"]
        flip_w = n_windows // 3
        flip_at = flip_w * VERIFY_WINDOW + 777
        flip_byte(base + pl.to_ext(SCRUB_SHARD), flip_at)
        rep = await counted("verify flipped", admin(
            "/admin/ec/verify", volume=str(vid), windowMB="1"))
        check(rep["bad_windows"] == [flip_w * VERIFY_WINDOW],
              f"one flipped byte in window {flip_w}: /admin/ec/verify "
              f"reported {rep['bad_windows']}")
        expected["verify flipped"] = rep["dispatches"]
        scrub = await counted("scrub", admin("/debug/scrub", run="1"))
        cycle = scrub["cycle"]
        found = [(w["volume"], w["offset"], w["shards"])
                 for w in cycle["corrupt_windows"]]
        check(found == [(vid, flip_w * VERIFY_WINDOW, [SCRUB_SHARD])]
              and cycle["errors"] == [],
              f"/debug/scrub cycle found {found} (errors "
              f"{cycle['errors']}), expected window {flip_w} localized to "
              f"shard {SCRUB_SHARD}")
        # 14 hypotheses, each a reconstruct and a re-verify
        expected["scrub"] = cycle["dispatches"] + 2 * gf.TOTAL_SHARDS
        flip_byte(base + pl.to_ext(SCRUB_SHARD), flip_at)
        print(f"  /admin/ec/verify windowMB=1: clean, {expected['verify']} "
              f"dispatches in {timing['verify']:.3f} s; after a flipped "
              f"byte of .ec12 only window {flip_w} in "
              f"{timing['verify flipped']:.3f} s; /debug/scrub?run=1: "
              f"{cycle['dispatches']} dispatches, window {flip_w} "
              f"localized to shard {SCRUB_SHARD}, {timing['scrub']:.3f} s "
              f"{tag}")
        for name, lat in (("A", lat_a), ("B", lat_b)):
            print(f"  GET pass {name}: {len(lat)} needles in "
                  f"{sum(lat):.3f} s = {len(lat) / sum(lat):.1f} needles/s, "
                  f"latency p50 {percentile_ms(lat, 50):.4f} ms, p99 "
                  f"{percentile_ms(lat, 99):.4f} ms {tag}")
        print(f"  wall seconds per step: "
              f"{ {k: round(v, 4) for k, v in timing.items()} } {tag}")
        print(f"  server path kernel launches per step: {launches} {tag}")
    finally:
        await http.close()
        await vs.stop()
        if rec is not None:
            rec.cancel()
    return {"launches": launches, "expected": expected, "timing": timing,
            "needles": len(order), "intervals": len(ivs),
            "split": (host_n, card_n), "parity_sha": parity_sha}


# -- phase 9: the volume server's MXU method over HTTP ------------------------

# phase 9's store directory (git-ignored): phase 8's sealed volume,
# hard-linked, and one more volume
MXU_DIR = os.path.join(ROOT, ".smoke_mxu")
MXU_EXTRA_VID = 2


def phase_mxu_server(dev: torch.device, seed: int, target: int,
                     extra: int, phase8: dict, card: str = "",
                     backend: str = "gpu") -> dict:
    """A fresh port volume server (cold caches) under
    SWTPU_TORCH_EC_METHOD=mxu on phase 8's sealed volume (in MXU_DIR) and
    one more volume of `extra` bytes written over HTTP:
    /admin/ec/generate_batch of both (parity sha256-equal to phase 8's,
    and to the host CpuEncoder's for the new one), every needle of phase
    8's volume read with shards {0,3,7,9} deleted (pass B, as many K4
    calls as phase 8's pass B launched K1), /admin/ec/rebuild, and a
    forced scrub cycle that localizes one flipped byte of .ec12 through
    K4. Returns the K4 calls, K4 launches and K1 launches per
    step and what the geometry and the reports say the calls and K1's
    launches must be (K4's launches must equal its calls)."""
    import asyncio
    prior = os.environ.get(pl.METHOD_ENV)
    os.environ[pl.METHOD_ENV] = "mxu"
    try:
        return asyncio.run(_drive_mxu_server(dev, seed, target, extra,
                                             phase8, card, backend))
    finally:
        if prior is None:
            os.environ.pop(pl.METHOD_ENV, None)
        else:
            os.environ[pl.METHOD_ENV] = prior
        shutil.rmtree(MXU_DIR, ignore_errors=True)


async def _drive_mxu_server(dev: torch.device, seed: int, target: int,
                            extra: int, phase8: dict, card: str,
                            backend: str) -> dict:
    import aiohttp
    from seaweedfs_tpu_torch import cli

    tag = f"[{card}]" if card else ""
    launches, expected, timing = {}, {}, {}
    vid, vid2 = SERVER_VID, MXU_EXTRA_VID
    base = os.path.join(MXU_DIR, str(vid))
    base2 = os.path.join(MXU_DIR, str(vid2))

    async def counted(step: str, coro):
        gf256_cuda.launches = 0
        gf256_mxu.launches = 0
        gf256_mxu.calls = 0
        t0 = time.perf_counter()
        out = await coro
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = {"K4 calls": gf256_mxu.calls,
                          "K4 launches": gf256_mxu.launches,
                          "K1": gf256_cuda.launches}
        return out

    vs, rec = await cli.start_volume(
        cli.build_parser().parse_args(server_args(backend, MXU_DIR)))
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
    url = f"http://{vs.url}"

    async def admin(path: str, **params) -> dict:
        async with http.post(url + path, params=params) as r:
            body = await r.json()
            check(r.status == 200, f"POST {path} {params}: {r.status} "
                  f"{body}")
            return body

    try:
        check(vid in vs.store.volumes, f"phase 8's volume {vid} not "
              f"mounted from {MXU_DIR}")
        # -- one more volume, written over HTTP
        await admin("/admin/volume/allocate", volume=str(vid2))
        written = 0
        for nid, cookie, data, name, mime in store_needle_specs(seed + 9,
                                                                extra):
            form = aiohttp.FormData()
            form.add_field("file", data, filename=name.decode(),
                           content_type=mime.decode())
            async with http.post(f"{url}/{vid2},{nid:x}{cookie:08x}",
                                 data=form) as r:
                check(r.status == 201, f"POST needle {nid} of volume "
                      f"{vid2}: {r.status}")
            written += len(data)
        await admin("/admin/volume/readonly", volume=str(vid2))

        # -- generate both in batched launches through K4
        rows = sum(len(list(pl._iter_row_batches(
            os.path.getsize(b + ".dat"), vs.store.ec_large_block,
            vs.store.ec_small_block, 8 * MIB))) for b in (base, base2))
        await counted("generate_batch", admin(
            "/admin/ec/generate_batch", volumes=f"{vid},{vid2}"))
        expected["generate_batch"] = {"K4 calls": math.ceil(rows / 8),
                                      "K1": 0}
        got_sha = {sid: sha_file(base + pl.to_ext(sid))
                   for sid in range(gf.DATA_SHARDS, gf.TOTAL_SHARDS)}
        check(got_sha == phase8["parity_sha"], "generate_batch parity of "
              "phase 8's volume differs from /admin/ec/generate's (sha256)")
        check(host_parity_matches(base2), f"generate_batch parity of volume "
              f"{vid2} differs from the host CpuEncoder's")
        print(f"  /admin/ec/generate_batch of volumes {vid} and {vid2} "
              f"({written} more needle bytes): {timing['generate_batch']:.3f}"
              f" s, {rows} buffer groups in {math.ceil(rows / 8)} K4 calls; "
              f"parity of volume {vid} sha256-equal to phase 8's, of "
              f"volume {vid2} equal to the host CpuEncoder's {tag}")

        # -- mount, drop the normal volume, lose {0,3,7,9}, read degraded
        mounted = await admin("/admin/ec/mount", volume=str(vid))
        check(mounted["shards"] == list(range(gf.TOTAL_SHARDS)),
              f"mounted shards {mounted}")
        await admin("/admin/volume/delete", volume=str(vid))
        sha_lost = {sid: sha_file(base + pl.to_ext(sid)) for sid in LOST}
        lost = ",".join(map(str, LOST))
        await admin("/admin/ec/unmount", volume=str(vid), shards=lost)
        await admin("/admin/ec/delete_shards", volume=str(vid), shards=lost)
        store = vs.store
        ev = store.ec_volumes[vid]
        specs, order = {}, []
        for nid, cookie, data, name, mime in store_needle_specs(seed,
                                                                target):
            specs[nid] = (cookie, data)
            order.append(nid)
        ivs = lost_intervals(base, LOST, store.ec_large_block,
                             store.ec_small_block, order)
        check_cache_cold(store, specs, ivs, vid)
        host_n, card_n = split_at(ivs, ev.small_recover_bytes)

        async def read_all() -> list[float]:
            lat = []
            for nid in order:
                cookie, data = specs[nid]
                t0 = time.perf_counter()
                async with http.get(f"{url}/{vid},{nid:x}{cookie:08x}") as r:
                    body = await r.read()
                    status = r.status
                lat.append(time.perf_counter() - t0)
                check(status == 200 and body == data,
                      f"GET needle {nid}: status {status}, {len(body)} "
                      f"bytes, expected {len(data)}")
            return lat

        lat_b = await counted("pass B", read_all())
        expected["pass B"] = {"K4 calls": card_n, "K1": 0}
        check(card_n == phase8["expected"]["pass B"],
              f"pass B: {card_n} recovers on the card, phase 8 had "
              f"{phase8['expected']['pass B']}")
        print(f"  pass B: {len(order)} needles equal with shards {LOST} "
              f"lost, {card_n} recovers through K4 and {host_n} on the host "
              f"CpuEncoder in {timing['pass B']:.3f} s, p50 "
              f"{percentile_ms(lat_b, 50):.4f} ms, p99 "
              f"{percentile_ms(lat_b, 99):.4f} ms {tag}")

        # -- rebuild (K1: rebuild_ec_files stays on the bitplane path)
        reb = await counted("rebuild",
                            admin("/admin/ec/rebuild", volume=str(vid)))
        check(reb["rebuilt"] == LOST, f"rebuilt {reb}, lost {LOST}")
        check({sid: sha_file(base + pl.to_ext(sid)) for sid in LOST}
              == sha_lost, "rebuilt shard files differ from the deleted "
              "ones (sha256)")
        n_windows = -(-ev.shard_size // VERIFY_WINDOW)
        expected["rebuild"] = {
            "K4 calls": 0,
            "K1": math.ceil(n_windows / ecb.DEFAULT_BATCH_WINDOWS)}
        await admin("/admin/ec/mount", volume=str(vid))

        # -- one flipped byte of .ec12, localized through K4
        flip_w = n_windows // 3
        flip_byte(base + pl.to_ext(SCRUB_SHARD), flip_w * VERIFY_WINDOW + 777)
        scrub = await counted("scrub", admin("/debug/scrub", run="1"))
        cycle = scrub["cycle"]
        found = [(w["volume"], w["offset"], w["shards"])
                 for w in cycle["corrupt_windows"]]
        check(found == [(vid, flip_w * VERIFY_WINDOW, [SCRUB_SHARD])]
              and cycle["errors"] == [],
              f"/debug/scrub cycle found {found} (errors "
              f"{cycle['errors']}), expected window {flip_w} localized to "
              f"shard {SCRUB_SHARD}")
        # 14 hypotheses: a reconstruct through K4 and a re-verify on K1
        expected["scrub"] = {"K4 calls": gf.TOTAL_SHARDS,
                             "K1": cycle["dispatches"] + gf.TOTAL_SHARDS}
        print(f"  rebuild {timing['rebuild']:.3f} s, sha256-equal; "
              f"/debug/scrub?run=1: window {flip_w} localized to shard "
              f"{SCRUB_SHARD} in {timing['scrub']:.3f} s {tag}")
        print(f"  wall seconds per step: "
              f"{ {k: round(v, 4) for k, v in timing.items()} } {tag}")
        print(f"  MXU path launches per step: {launches} {tag}")
    finally:
        await http.close()
        await vs.stop()
        if rec is not None:
            rec.cancel()
    return {"launches": launches, "expected": expected, "timing": timing}


def check_mxu_counts(seen: dict) -> tuple[int, int]:
    """Each step's K4 calls and K1 launches equal its expected counts, and
    K4 launched its kernel exactly once per call; returns the K4 launches
    and calls of the path."""
    for step, want in seen["expected"].items():
        got = seen["launches"][step]
        check({key: got[key] for key in want} == want
              and got["K4 launches"] == got["K4 calls"],
              f"MXU path, {step}: counts {got}, expected {want} and one "
              f"K4 launch a call")
    return (sum(v["K4 launches"] for v in seen["launches"].values()),
            sum(v["K4 calls"] for v in seen["launches"].values()))


# -- phase 10: -workers 2 on the card -----------------------------------------

WORKERS_DIR = os.path.join(ROOT, ".smoke_workers")


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def cuda_device_files(pid: int) -> list[str]:
    """The NVIDIA device files a process holds open, from /proc/<pid>/fd:
    a process with a CUDA context holds /dev/nvidiactl, /dev/nvidia-uvm
    and its card's /dev/nvidia<N>. (nvidia-smi's compute apps cannot
    name the workers in a container whose pid namespace it does not see.)"""
    out = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def smi_apps() -> str:
    """nvidia-smi's compute apps, as it lists them (for the log)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


def holds_cuda_context(pid: int) -> bool:
    files = cuda_device_files(pid)
    return "/dev/nvidiactl" in files and "/dev/nvidia-uvm" in files and \
        any(re.fullmatch(r"/dev/nvidia\d+", f) for f in files)


def phase_workers(seed: int, target: int, card: str = "",
                  backend: str = "gpu", deadline_s: float = 180.0) -> dict:
    """`python -m seaweedfs_tpu_torch.cli volume -workers 2 -ecBackend
    <backend>` as a subprocess on a free port: one volume of `target`
    bytes in each worker's partition, written through the shared port;
    /admin/ec/generate of both (dispatches = ceil(W/8), parity equal to
    the host CpuEncoder's); shards {0,3,7,9} of worker 1's volume deleted
    and every needle of it read through the shared port; on the card,
    both worker pids in nvidia-smi's compute apps; worker 1 SIGKILLed,
    and once the supervisor has respawned it, the same reads equal again
    (and the new pid on the card). Stops every process it started."""
    import asyncio
    import signal
    shutil.rmtree(WORKERS_DIR, ignore_errors=True)
    os.makedirs(WORKERS_DIR)
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", pl.METHOD_ENV)}
    log = open(os.path.join(WORKERS_DIR, "supervisor.log"), "w")
    sup = subprocess.Popen(
        [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume",
         "-port", str(port), "-dir", WORKERS_DIR, "-master", dead_master(),
         "-workers", "2", "-ecBackend", backend, "-timeline.interval", "0",
         "-cache.mem", "32", "-ec.smallrecover", str(MIB)],
        cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
    log.close()
    pids: set[int] = set()
    try:
        return asyncio.run(_drive_workers(seed, target, card, port,
                                          deadline_s, pids,
                                          backend == "gpu"))
    except BaseException:
        with open(os.path.join(WORKERS_DIR, "supervisor.log")) as f:
            print("  supervisor log (tail):\n" + f.read()[-4000:])
        raise
    finally:
        sup.send_signal(signal.SIGTERM)
        try:
            sup.wait(timeout=30)
        except subprocess.TimeoutExpired:
            sup.kill()
            sup.wait(timeout=30)
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        shutil.rmtree(WORKERS_DIR, ignore_errors=True)


async def _drive_workers(seed: int, target: int, card: str, port: int,
                         deadline_s: float, pids: set[int],
                         on_card: bool) -> dict:
    import asyncio
    import aiohttp
    import signal
    tag = f"[{card}]" if card else ""
    shared = f"http://127.0.0.1:{port}"
    timing = {}
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))

    async def until(what: str, probe):
        """probe() until it returns a true value, within deadline_s."""
        end = time.monotonic() + deadline_s
        last = None
        while time.monotonic() < end:
            try:
                got = await probe()
                if got:
                    return got
            except (aiohttp.ClientError, OSError, KeyError,
                    ValueError) as e:
                last = e
            await asyncio.sleep(0.2)
        raise RuntimeError(f"-workers 2: {what} not within {deadline_s} s "
                           f"({last})")

    async def rows():
        async with http.get(f"{shared}/stats/workers") as r:
            got = (await r.json())["workers"]
        return got if len(got) == 2 and all(w["alive"] for w in got) \
            else None

    async def admin(path: str, **params) -> dict:
        async with http.post(shared + path, params=params) as r:
            body = await r.json()
            check(r.status == 200, f"POST {path} {params}: {r.status} "
                  f"{body}")
            return body

    async def allocate(vid: int):
        # 503 while the entry worker has not yet found its sibling
        async with http.post(f"{shared}/admin/volume/allocate",
                             params={"volume": str(vid)}) as r:
            return r.status == 200

    try:
        t0 = time.perf_counter()
        workers = await until("both workers up", rows)
        timing["start"] = time.perf_counter() - t0
        pids.update(w["pid"] for w in workers)
        by_index = {w["index"]: w["pid"] for w in workers}
        # volume 1 is worker 1's (1 % 2), volume 2 worker 0's
        specs = {}
        t0 = time.perf_counter()
        for vid in (1, 2):
            await until(f"allocate volume {vid}", lambda vid=vid:
                        allocate(vid))
            specs[vid] = {}
            for nid, cookie, data, name, mime in store_needle_specs(
                    seed + 10 + vid, target):
                form = aiohttp.FormData()
                form.add_field("file", data, filename=name.decode(),
                               content_type=mime.decode())
                async with http.post(f"{shared}/{vid},{nid:x}{cookie:08x}",
                                     data=form) as r:
                    check(r.status == 201, f"POST needle {nid} of volume "
                          f"{vid} through the shared port: {r.status}")
                specs[vid][nid] = (cookie, data)
            await admin("/admin/volume/readonly", volume=str(vid))
        timing["write"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for vid in (1, 2):
            gen = await admin("/admin/ec/generate", volume=str(vid))
            want = math.ceil(gen["windows"] / ecb.DEFAULT_BATCH_WINDOWS)
            check(gen["dispatches"] == want, f"volume {vid}: "
                  f"{gen['dispatches']} dispatches for {gen['windows']} "
                  f"windows, expected {want}")
            check(host_parity_matches(os.path.join(WORKERS_DIR, str(vid))),
                  f"volume {vid}: parity differs from the host CpuEncoder's")
        timing["generate"] = time.perf_counter() - t0
        await admin("/admin/ec/mount", volume="1")
        await admin("/admin/volume/delete", volume="1")
        lost = ",".join(map(str, LOST))
        await admin("/admin/ec/unmount", volume="1", shards=lost)
        await admin("/admin/ec/delete_shards", volume="1", shards=lost)

        async def read_volume_1() -> bool:
            for nid, (cookie, data) in specs[1].items():
                async with http.get(f"{shared}/1,{nid:x}{cookie:08x}") as r:
                    body = await r.read()
                    check(r.status == 200 and body == data,
                          f"GET needle {nid} of volume 1 through the shared "
                          f"port: status {r.status}, {len(body)} bytes")
            return True

        t0 = time.perf_counter()
        await read_volume_1()
        timing["degraded GETs"] = time.perf_counter() - t0
        contexts = {i: cuda_device_files(pid) for i, pid in by_index.items()}
        if on_card:
            check(all(holds_cuda_context(pid) for pid in by_index.values()),
                  f"workers {by_index} do not each hold a CUDA context: "
                  f"device files {contexts}")
        print(f"  -workers 2 on port {port}: workers {by_index} up in "
              f"{timing['start']:.3f} s; {sum(map(len, specs.values()))} "
              f"needles written to volumes 1 and 2 through the shared port "
              f"in {timing['write']:.3f} s; /admin/ec/generate of both "
              f"{timing['generate']:.3f} s, parity equal to the host "
              f"CpuEncoder's; {len(specs[1])} needles of volume 1 equal "
              f"with shards {LOST} lost in {timing['degraded GETs']:.3f} s; "
              f"device files held by each worker {contexts}; nvidia-smi "
              f"compute apps {smi_apps()!r} {tag}")

        # -- SIGKILL worker 1, wait for the respawn, read again
        os.kill(by_index[1], signal.SIGKILL)
        t0 = time.perf_counter()

        async def respawned():
            got = await rows()
            new = [w for w in got or () if w["index"] == 1
                   and w["pid"] != by_index[1]]
            return new[0] if new else None

        new = await until("worker 1 respawned", respawned)
        pids.add(new["pid"])
        await until("volume 1 served again", read_volume_1)
        timing["respawn and GETs"] = time.perf_counter() - t0
        after = cuda_device_files(new["pid"])
        if on_card:
            check(holds_cuda_context(new["pid"]), f"respawned worker 1 "
                  f"(pid {new['pid']}) holds no CUDA context: device files "
                  f"{after}")
        print(f"  worker 1 (pid {by_index[1]}) SIGKILLed, respawned as pid "
              f"{new['pid']}; volume 1's needles equal again "
              f"{timing['respawn and GETs']:.3f} s after the kill; device "
              f"files held by the new worker {after} {tag}")
    finally:
        await http.close()
    return {"timing": timing, "pids": by_index, "respawned": new["pid"]}


# -- phase 11: the port's own cluster ---------------------------------------

# phase 11's directory (git-ignored): `src` holds phase 8's sealed volume,
# hard-linked before phase 9 drops it; `run` the master's metadata and the
# two volume servers' stores
CLUSTER_DIR = os.path.join(ROOT, ".smoke_cluster")
CLUSTER_SRC = os.path.join(CLUSTER_DIR, "src")
# bytes written through /dir/assign and POST, at phase 7's size mix
CLUSTER_ASSIGN_MIB = 64
# shell.ec_commands.ec_verify's default -windowMB
SHELL_VERIFY_WINDOW = 4 * MIB
# volume slots per server: ec.encode spreads the 14 shards one each way
# in turn only while both servers have free slots
CLUSTER_MAX_VOLUMES = 20


def link_volume(src_dir: str, dst_dir: str, vid: int) -> None:
    """Hard-link a sealed volume's .dat and .idx into another directory."""
    os.makedirs(dst_dir, exist_ok=True)
    for ext in (".dat", ".idx"):
        os.link(os.path.join(src_dir, str(vid) + ext),
                os.path.join(dst_dir, str(vid) + ext))


def cluster_master_args(directory: str, limit_mb: int) -> list[str]:
    """The port CLI's `master` command line for phase 11: port 0, the
    volume size limit (the size the phase's volume was filled to, 1024 MB
    at full width, so the sealed volume is full and takes no writes), and
    an unpaced repair
    budget (-autopilot.mbps 0: the default 16 MB/s would pace a 1 GiB
    rebuild over a minute; the scrubber runs unpaced too)."""
    return ["master", "-port", "0", "-mdir", os.path.join(directory, "m"),
            "-volumeSizeLimitMB", str(limit_mb), "-autopilot.mbps", "0"]


def batched_generate_launches(dat_size: int, large_block: int,
                              small_block: int) -> int:
    """Launches of pipeline.write_ec_files_batched for one volume: its row
    batches are queued per buffer length and flushed 8 at a time."""
    per_len = Counter(buf for _, _, buf, _ in pl._iter_row_batches(
        dat_size, large_block, small_block, 8 * MIB))
    return sum(math.ceil(n / 8) for n in per_len.values())


def rebuild_launches(shard_size: int) -> int:
    """Launches of pipeline.rebuild_ec_files: 1 MiB windows, 8 a launch."""
    return math.ceil(-(-shard_size // VERIFY_WINDOW)
                     / ecb.DEFAULT_BATCH_WINDOWS)


def verify_launches(shard_size: int, window: int) -> int:
    """Dispatches of EcVolume.verify_parity over `window`-byte windows."""
    batch = ecb.clamp_batch_windows(ecb.DEFAULT_BATCH_WINDOWS, window,
                                    gf.TOTAL_SHARDS)
    return math.ceil(-(-shard_size // window) / batch)


def server_layout(seed: int, target: int) -> tuple[int, list[tuple]]:
    """The .dat size and each needle's (nid, offset, size field) of the
    volume phase 8 writes from `seed` up to `target` bytes, reckoned
    without writing it: each record as the server stores a multipart
    POST (data, flags, name, the part's type unless it is
    application/octet-stream, a last-modified time)."""
    from seaweedfs_tpu_torch.storage.needle import LAST_MODIFIED_BYTES
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    pos, out = SUPER_BLOCK_SIZE, []
    for nid, _, data, name, mime in store_needle_specs(seed, target):
        kept = b"" if mime == b"application/octet-stream" else mime
        size = (4 + len(data) + 1 + 1 + len(name)
                + (1 + len(kept) if kept else 0) + LAST_MODIFIED_BYTES)
        out.append((nid, pos, size))
        pos += st.actual_size(size, st.CURRENT_VERSION)
    return pos, out


def cluster_prediction(seed: int, target: int,
                       lost: tuple = (0, 2, 4, 6)) -> dict:
    """Phase 11's K1 launches per step for the volume phase 8 writes from
    `seed` up to `target` bytes, with `lost` the shards of one server
    deleted before pass B, reckoned on any host from the needle layout
    (server_layout) and the server's defaults: 1 GiB large and 1 MiB
    small blocks, 1 MiB recover threshold, the shell's 4 MiB verify
    windows, the scrubber's 1 MiB windows. The autopilot's rebuild is two
    rebuild_shard actions, one on each server."""
    from seaweedfs_tpu_torch.ec.locate import locate_data
    from seaweedfs_tpu_torch.ec.scrub import Scrubber
    dat_size, layout = server_layout(seed, target)
    large, small = pl.LARGE_BLOCK_SIZE, pl.SMALL_BLOCK_SIZE
    shard = sum(buf for _, _, buf, _ in pl._iter_row_batches(
        dat_size, large, small, 8 * MIB))
    recovers = 0
    for _, off, size in layout:
        for iv in locate_data(large, small, gf.DATA_SHARDS * shard, off,
                              st.actual_size(size, st.CURRENT_VERSION)):
            sid, _ = iv.to_shard_and_offset(large, small)
            recovers += sid in lost and iv.size >= MIB
    rebuild = rebuild_launches(shard)
    scrub_batch = ecb.clamp_batch_windows(
        ecb.DEFAULT_BATCH_WINDOWS, VERIFY_WINDOW, gf.TOTAL_SHARDS,
        budget=Scrubber.BLOCK_BYTES)
    verify = verify_launches(shard, SHELL_VERIFY_WINDOW)
    return {"assign reads": 0,
            "ec.encode": batched_generate_launches(dat_size, large, small),
            "pass A": 0, "pass B": recovers, "autopilot": 2 * rebuild,
            "ec.verify": verify, "ec.verify flipped": verify,
            "scrub": math.ceil(-(-shard // VERIFY_WINDOW) / scrub_batch)
            + 2 * gf.TOTAL_SHARDS,
            "ec.rebuild": rebuild, "ec.decode": rebuild,
            "decoded reads": 0}


# top-level packages no process of the port may load
FORBIDDEN_PACKAGES = ("jax", "jaxlib", "seaweedfs_tpu")


def forbidden_imports(importtime_log: str) -> list[str]:
    """Modules of jax or of the JAX package in a `python -X importtime`
    log: every module that process imported is on a line of its own."""
    out = []
    for line in importtime_log.splitlines():
        if line.startswith("import time:"):
            mod = line.rsplit("|", 1)[-1].strip()
            if mod.split(".")[0] in FORBIDDEN_PACKAGES:
                out.append(mod)
    return out


def forbidden_loaded() -> list[str]:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN_PACKAGES)


def phase_cluster(dev: torch.device, seed: int, target: int,
                  source_dir: str, *, limit_mb: int, card: str = "",
                  backend: str = "gpu",
                  assign_bytes: int = CLUSTER_ASSIGN_MIB * MIB,
                  parity_sha: dict | None = None) -> dict:
    """The port's own cluster, no module of seaweedfs_tpu in any of its
    processes: a port master (cli.start_master) and two port volume
    servers (cli.start_volume, -ecBackend <backend>) in this process, the
    port's shell (in process, and in a subprocess through `python -m
    seaweedfs_tpu_torch.cli shell -c`). Phase 8's sealed volume (made
    from `seed` up to `target` bytes, in `source_dir`) is the EC volume;
    `assign_bytes` more go through /dir/assign and POST, under a master
    whose -volumeSizeLimitMB is `limit_mb`, at most the sealed volume's
    size, so that no assign lands in it. Steps: write;
    ec.encode spreading the shards over both servers (parity sha256-equal
    to `parity_sha`, phase 8's, when given); every needle through
    /dir/lookup and GET intact and with 4 shards of one server lost; a
    forced autopilot cycle that rebuilds them with remote sources; ec.verify
    clean and after one flipped byte of .ec12, and a forced scrub that
    localizes it; ec.rebuild of 4 lost shards; ec.decode back to a normal
    volume whose .dat is sha256-equal to the original. Returns the launch
    counts and what the geometry and the reports say they must be."""
    import asyncio
    run_dir = os.path.join(CLUSTER_DIR, "run")
    shutil.rmtree(run_dir, ignore_errors=True)
    for d in ("m", "v0", "v1"):
        os.makedirs(os.path.join(run_dir, d))
    link_volume(source_dir, os.path.join(run_dir, "v0"), SERVER_VID)
    dat = os.path.join(source_dir, f"{SERVER_VID}.dat")
    check(os.path.getsize(dat) >= limit_mb * MIB,
          f"{dat} holds {os.path.getsize(dat)} bytes, under the master's "
          f"{limit_mb} MB limit: /dir/assign could place needles in it")
    try:
        return asyncio.run(_drive_cluster(dev, seed, target, run_dir,
                                          card, backend, assign_bytes,
                                          parity_sha, limit_mb))
    finally:
        shutil.rmtree(CLUSTER_DIR, ignore_errors=True)


async def _drive_cluster(dev: torch.device, seed: int, target: int,
                         run_dir: str, card: str, backend: str,
                         assign_bytes: int, parity_sha: dict | None,
                         limit_mb: int) -> dict:
    import asyncio
    import aiohttp
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.shell.runner import dispatch
    from seaweedfs_tpu_torch.util import crc32c

    tag = f"[{card}]" if card else ""
    launches, expected, timing = {}, {}, {}
    vid = SERVER_VID
    parser = cli.build_parser()

    async def counted(step: str, coro):
        gf256_cuda.launches = 0
        t0 = time.perf_counter()
        out = await coro
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = gf256_cuda.launches
        return out

    def in_thread(fn, *args):
        return asyncio.get_running_loop().run_in_executor(None, fn, *args)

    master, mrec = await cli.start_master(parser.parse_args(
        cluster_master_args(run_dir, limit_mb)))
    servers, recs = [], [mrec]
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
    try:
        for i in range(2):
            vs, rec = await cli.start_volume(parser.parse_args(
                server_args(backend, os.path.join(run_dir, f"v{i}"),
                            master=master.url)
                + ["-max", str(CLUSTER_MAX_VOLUMES)]))
            servers.append(vs)
            recs.append(rec)
            check(await vs.heartbeat_once(),
                  f"volume server {vs.url} not registered with the master")
        by_url = {vs.url: vs for vs in servers}

        async def post(url: str, path: str, **params) -> dict:
            async with http.post(f"http://{url}{path}", params=params) as r:
                body = await r.json()
                check(r.status == 200, f"POST {url}{path} {params}: "
                      f"{r.status} {body}")
                return body

        async def lookup(v: int) -> str:
            async with http.get(f"http://{master.url}/dir/lookup",
                                params={"volumeId": str(v)}) as r:
                body = await r.json()
                check(r.status == 200 and body.get("locations"),
                      f"/dir/lookup {v}: {r.status} {body}")
                return body["locations"][0]["url"]

        async def read_all(fids: list[tuple[str, bytes]]) -> list[float]:
            """Every needle through /dir/lookup and GET, byte- and
            CRC-equal (the ETag is the data's CRC)."""
            lat = []
            for fid, data in fids:
                t0 = time.perf_counter()
                url = await lookup(int(fid.split(",")[0]))
                async with http.get(f"http://{url}/{fid}") as r:
                    body = await r.read()
                    status, etag = r.status, r.headers.get("ETag")
                lat.append(time.perf_counter() - t0)
                check(status == 200 and body == data,
                      f"GET {fid} from {url}: status {status}, "
                      f"{len(body)} bytes, expected {len(data)}")
                check(etag == f'"{crc32c.crc32c(data) & 0xFFFFFFFF:08x}"',
                      f"GET {fid}: ETag {etag} is not the data's CRC")
            return lat

        async def shell(command: str):
            """One line through the port's shell in this process."""
            async with CommandEnv(master.url, http) as env:
                return await dispatch(env, command)

        async def shell_cli(command: str):
            """One line through `python -m seaweedfs_tpu_torch.cli shell
            -c` in a subprocess; -X importtime lists every module it
            imported, none of which may be jax's or seaweedfs_tpu's."""
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-X", "importtime", "-m",
                "seaweedfs_tpu_torch.cli", "shell", "-master", master.url,
                "-c", command, cwd=ROOT, env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            try:
                out, err = await asyncio.wait_for(proc.communicate(), 600)
            except BaseException:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
                raise
            err_text = err.decode(errors="replace")
            check(proc.returncode == 0, f"shell -c {command!r}: exit "
                  f"{proc.returncode}: {err_text[-2000:]}")
            bad = forbidden_imports(err_text)
            check(bad == [], f"shell -c {command!r} imported {bad[:5]}")
            check("import time:" in err_text,
                  "the shell subprocess printed no -X importtime log")
            return json.loads(out)

        def holders() -> dict[int, list]:
            """shard id -> the servers that mount it."""
            out: dict[int, list] = {}
            for vs in servers:
                ev = vs.store.ec_volumes.get(vid)
                for sid in (sorted(ev.shards) if ev is not None else []):
                    out.setdefault(sid, []).append(vs)
            return out

        def base_of(vs) -> str:
            return os.path.join(vs.store.dirs[0], str(vid))

        def shard_path(vs, sid: int) -> str:
            return base_of(vs) + pl.to_ext(sid)

        async def lose(vs, sids: list[int]) -> None:
            arg = ",".join(map(str, sids))
            await post(vs.url, "/admin/ec/unmount", volume=str(vid),
                       shards=arg)
            await post(vs.url, "/admin/ec/delete_shards", volume=str(vid),
                       shards=arg)
            check(not any(os.path.exists(shard_path(vs, s)) for s in sids),
                  f"lost shard files {sids} still on {vs.url}")

        def drop_caches() -> None:
            for vs in servers:
                vs.store.drop_cached_volume(vid)
                vs.store.ec_recover_cache.drop_volume(vid)

        # -- 1. write through the master's assign path
        src_base = os.path.join(run_dir, "v0", str(vid))
        dat_size = os.path.getsize(src_base + ".dat")
        dat_sha = await in_thread(sha_file, src_base + ".dat")
        volume, nids = [], []
        for nid, cookie, data, _, _ in store_needle_specs(seed, target):
            volume.append((f"{vid},{nid:x}{cookie:08x}", data))
            nids.append(nid)
        assigned, written = [], 0
        t0 = time.perf_counter()
        for _, _, data, name, mime in store_needle_specs(seed + 11,
                                                         assign_bytes):
            async with http.get(f"http://{master.url}/dir/assign") as r:
                a = await r.json()
            check(r.status == 200 and "fid" in a, f"/dir/assign: {a}")
            form = aiohttp.FormData()
            form.add_field("file", data, filename=name.decode(),
                           content_type=mime.decode())
            async with http.post(f"http://{a['url']}/{a['fid']}",
                                 data=form) as r:
                check(r.status == 201, f"POST {a['fid']}: {r.status} "
                      f"{await r.text()}")
            assigned.append((a["fid"], data))
            written += len(data)
        timing["write"] = time.perf_counter() - t0
        check(written >= assign_bytes, f"{written} bytes through assign")
        check(all(int(fid.split(",")[0]) != vid for fid, _ in assigned)
              and os.path.getsize(src_base + ".dat") == dat_size,
              f"/dir/assign placed needles in the sealed volume {vid}")
        await counted("assign reads", read_all(assigned))
        expected["assign reads"] = 0
        check(await lookup(vid) == servers[0].url,
              f"volume {vid} not located on {servers[0].url}")
        print(f"  write: {len(assigned)} needles, {written} bytes through "
              f"/dir/assign and POST in {timing['write']:.3f} s "
              f"({written / timing['write'] / 1e6:.1f} MB/s), read back "
              f"through /dir/lookup in {timing['assign reads']:.3f} s; "
              f"volume {vid}: {len(volume)} needles, .dat {dat_size} "
              f"bytes {tag}")

        # -- 2. ec.encode through the shell's CLI in a subprocess
        store0 = servers[0].store
        res = await counted("ec.encode",
                            shell_cli(f"ec.encode -volumeId {vid}"))
        expected["ec.encode"] = batched_generate_launches(
            dat_size, store0.ec_large_block, store0.ec_small_block)
        check(isinstance(res, list) and len(res) == 1
              and res[0]["volume"] == vid, f"ec.encode answered {res}")
        spread = {u: sorted(s) for u, s in res[0]["assignments"].items()}
        check(len(spread) == 2 and set(spread) == set(by_url)
              and sorted(sum(spread.values(), [])) ==
              list(range(gf.TOTAL_SHARDS)),
              f"ec.encode spread the shards as {spread}")
        for vs in servers:
            await vs.heartbeat_once()
        where = holders()
        check({sid: [vs.url for vs in hs] for sid, hs in where.items()}
              == {sid: [u] for u, ss in spread.items() for sid in ss},
              f"mounted shards {where} differ from ec.encode's {spread}")
        check(not any(vid in vs.store.volumes for vs in servers),
              "the normal volume is still mounted after ec.encode")
        orig_sha = {sid: await in_thread(sha_file, shard_path(hs[0], sid))
                    for sid, hs in where.items()}
        if parity_sha is not None:
            check({s: orig_sha[s] for s in parity_sha} == parity_sha,
                  "ec.encode's parity differs from phase 8's (sha256)")
        shard_size = servers[0].store.ec_volumes[vid].shard_size
        print(f"  ec.encode -volumeId {vid} (shell -c in a subprocess, no "
              f"jax or seaweedfs_tpu imported): {timing['ec.encode']:.3f} "
              f"s, shards {spread}, shard size {shard_size} {tag}")

        # -- 3. GETs intact, then with 4 shards of one server lost
        lat_a = await counted("pass A", read_all(volume))
        expected["pass A"] = 0
        victim = where[0][0]
        other = next(vs for vs in servers if vs is not victim)
        lost = spread[victim.url][:4]
        await lose(victim, lost)
        drop_caches()
        present = next(s for s in range(gf.TOTAL_SHARDS) if s not in lost)
        ivs = lost_intervals(base_of(holders()[present][0]), lost,
                             store0.ec_large_block, store0.ec_small_block,
                             nids)
        for vs in servers:
            check_cache_cold(vs.store, dict.fromkeys(nids), ivs, vid)
        threshold = other.store.ec_volumes[vid].small_recover_bytes
        host_n, card_n = split_at(ivs, threshold)
        lat_b = await counted("pass B", read_all(volume))
        expected["pass B"] = card_n
        print(f"  pass B: shards {lost} lost on {victim.url}, "
              f"{len(ivs)} intervals on them: {host_n} under the "
              f"{threshold}-byte threshold (host), {card_n} at or above "
              f"it (the EC engine); the rest gathered from the other "
              f"server {tag}")

        # -- 4. the autopilot repairs the volume with remote sources
        rep = await counted("autopilot", post(master.url, "/debug/autopilot",
                                              run="1"))
        cycle = rep["cycle"]
        done = cycle["executed"]
        check(done and all(r["status"] == "ok" for r in done)
              and sorted(s for r in done for s in r["action"]["shards"])
              == lost and all(r["action"]["kind"] == "rebuild_shard"
                              for r in done),
              f"autopilot cycle executed {done} (deferred "
              f"{cycle['deferred']}), expected a rebuild of {lost}")
        check(all(any(u != r["target"] for _, u in r["action"]["sources"])
                  for r in done),
              "an autopilot rebuild had no remote source")
        rebuild_n = rebuild_launches(shard_size)
        expected["autopilot"] = len(done) * rebuild_n
        where = holders()
        check(sorted(where) == list(range(gf.TOTAL_SHARDS)),
              f"after the autopilot cycle shards {sorted(where)} mounted")
        for sid in lost:
            check(await in_thread(sha_file, shard_path(where[sid][0], sid))
                  == orig_sha[sid], f"autopilot rebuilt shard {sid} "
                  f"differs from the original (sha256)")
        print(f"  autopilot (POST /debug/autopilot?run=1): "
              f"{timing['autopilot']:.3f} s, {len(done)} rebuild_shard "
              f"actions {[(r['target'], r['action']['shards']) for r in done]}"
              f", each gathering remote sources; rebuilt shards "
              f"sha256-equal {tag}")

        # -- 5. ec.verify clean, then one flipped byte of .ec12; the
        # scrub of shard 0's holder localizes it. First every server's
        # EC location cache must see the repaired shards: after a failed
        # fetch it re-resolves at most once per FRESH_S (11 s), the
        # reference's staleness window, and until then ec.verify and the
        # scrub would count the re-hosted shards as missing
        t0 = time.perf_counter()
        for vs in servers:
            while True:
                vs._ec_locations.invalidate(vid)
                locs = await in_thread(vs._ec_locations.get, vid) or {}
                if all(locs.get(str(s)) for s in range(gf.TOTAL_SHARDS)):
                    break
                check(time.perf_counter() - t0 < 60, f"{vs.url} never saw "
                      f"every shard of volume {vid} located: {locs}")
                await asyncio.sleep(0.5)
        timing["locations"] = time.perf_counter() - t0
        reports = await counted("ec.verify", shell(f"ec.verify -volumeId "
                                                   f"{vid}"))
        check(len(reports) == 1 and reports[0]["bad_windows"] == []
              and reports[0]["missing_shards"] == [],
              f"ec.verify of the repaired volume: {reports}")
        expected["ec.verify"] = verify_launches(shard_size,
                                                SHELL_VERIFY_WINDOW)
        n4 = -(-shard_size // SHELL_VERIFY_WINDOW)
        flip_at = (n4 // 3) * SHELL_VERIFY_WINDOW + 777
        flip_byte(shard_path(where[SCRUB_SHARD][0], SCRUB_SHARD), flip_at)
        reports = await counted("ec.verify flipped",
                                shell(f"ec.verify -volumeId {vid}"))
        check(len(reports) == 1 and reports[0]["bad_windows"]
              == [(n4 // 3) * SHELL_VERIFY_WINDOW],
              f"one flipped byte of .ec{SCRUB_SHARD} at {flip_at}: "
              f"ec.verify reported {reports}")
        expected["ec.verify flipped"] = expected["ec.verify"]
        owner = where[0][0]
        scrub = await counted("scrub", post(owner.url, "/debug/scrub",
                                           run="1"))
        found = [(w["volume"], w["offset"], w["shards"])
                 for w in scrub["cycle"]["corrupt_windows"]]
        flip_w = flip_at // VERIFY_WINDOW * VERIFY_WINDOW
        check(found == [(vid, flip_w, [SCRUB_SHARD])]
              and scrub["cycle"]["errors"] == [],
              f"scrub of {owner.url} found {found} (errors "
              f"{scrub['cycle']['errors']}), expected the window at "
              f"{flip_w} localized to shard {SCRUB_SHARD}")
        # 14 hypotheses, each a reconstruct and a re-verify
        expected["scrub"] = scrub["cycle"]["dispatches"] \
            + 2 * gf.TOTAL_SHARDS
        print(f"  ec.verify: clean in {timing['ec.verify']:.3f} s; after "
              f"a flipped byte of .ec{SCRUB_SHARD} the window at "
              f"{(n4 // 3) * SHELL_VERIFY_WINDOW} in "
              f"{timing['ec.verify flipped']:.3f} s; /debug/scrub?run=1 on "
              f"shard 0's holder localized it to shard {SCRUB_SHARD} in "
              f"{timing['scrub']:.3f} s {tag}")

        # -- 6. ec.rebuild of the rotten .ec12 and 3 shards of the other
        # server
        holder12 = where[SCRUB_SHARD][0]
        other = next(vs for vs in servers if vs is not holder12)
        lost2 = [s for s, hs in sorted(where.items())
                 if hs[0] is other][:3]
        await lose(holder12, [SCRUB_SHARD])
        await lose(other, lost2)
        lost2 = sorted(lost2 + [SCRUB_SHARD])
        results = await counted("ec.rebuild", shell("ec.rebuild -force"))
        check(len(results) == 1 and results[0].get("rebuilt") == lost2,
              f"ec.rebuild of {lost2}: {results}")
        expected["ec.rebuild"] = rebuild_n
        where = holders()
        check(sorted(where) == list(range(gf.TOTAL_SHARDS)),
              f"after ec.rebuild shards {sorted(where)} mounted")
        for sid in lost2:
            check(await in_thread(sha_file, shard_path(where[sid][0], sid))
                  == orig_sha[sid], f"ec.rebuild's shard {sid} differs "
                  f"from the original (sha256)")
        print(f"  ec.rebuild of {lost2} on {results[0]['node']}: "
              f"{timing['ec.rebuild']:.3f} s, sha256-equal to the "
              f"originals (the flipped .ec{SCRUB_SHARD} repaired) {tag}")

        # -- 7. ec.decode (through the CLI) with data shard 0 lost: the
        # target rebuilds it, then reassembles the .dat
        await lose(where[0][0], [0])
        res = await counted("ec.decode",
                            shell_cli(f"ec.decode -volumeId {vid}"))
        check(len(res) == 1 and "error" not in res[0],
              f"ec.decode answered {res}")
        expected["ec.decode"] = rebuild_n
        target_vs = by_url[res[0]["node"]]
        for vs in servers:
            await vs.heartbeat_once()
        check(vid in target_vs.store.volumes and
              not any(vid in vs.store.ec_volumes for vs in servers),
              "after ec.decode the volume is not a normal volume only")
        for vs in servers:
            check(not any(os.path.exists(shard_path(vs, s))
                          for s in range(gf.TOTAL_SHARDS)),
                  f"EC shard files left on {vs.url} after ec.decode")
        decoded = base_of(target_vs) + ".dat"
        check(await in_thread(sha_file, decoded) == dat_sha,
              "the decoded .dat differs from the original (sha256)")
        await counted("decoded reads", read_all(volume + assigned))
        expected["decoded reads"] = 0
        print(f"  ec.decode (shell -c in a subprocess) on {target_vs.url}: "
              f"{timing['ec.decode']:.3f} s, .dat sha256-equal to the "
              f"original; every needle read back through /dir/lookup in "
              f"{timing['decoded reads']:.3f} s {tag}")
        for name, lat in (("A", lat_a), ("B", lat_b)):
            print(f"  GET pass {name} through /dir/lookup: {len(lat)} "
                  f"needles in {sum(lat):.3f} s, latency p50 "
                  f"{percentile_ms(lat, 50):.4f} ms, p99 "
                  f"{percentile_ms(lat, 99):.4f} ms {tag}")
        print(f"  wall seconds per step: "
              f"{ {k: round(v, 4) for k, v in timing.items()} } {tag}")
        print(f"  cluster path kernel launches per step: {launches} {tag}")
    finally:
        await http.close()
        for vs in servers:
            await vs.stop()
        await master.stop()
        for rec in recs:
            if rec is not None:
                rec.cancel()
    return {"launches": launches, "expected": expected, "timing": timing,
            "needles": len(volume), "intervals": len(ivs),
            "split": (host_n, card_n), "lost": lost, "lost2": lost2}


FILER_DIR = os.path.join(ROOT, ".smoke_filer")
# the filer's own collection: ec.encode -collection takes its volume only
FILER_COLLECTION = "filer12"
# small files per GiB of tree (about 2,000 in the 1 GiB tree, at least one
# a directory in a smaller one) and their size range
FILER_SMALL_PER_GIB = 2000
FILER_SMALL = (1 << 10, 64 << 10)
# the large files' range, drawn log-uniform: about 50 fill the rest of a
# 1 GiB tree, and the quarter of them over 32 MiB span 2-3 chunks
FILER_LARGE = (MIB, 96 * MIB)
# directory fan-out per level: 2 + 8 + 32 = 42 directories, 3 deep
FILER_FANOUT = (2, 4, 4)
# the filer CLI's -chunkSizeMB default (seaweedfs_tpu/cli.py:311)
FILER_CHUNK_MB = 32
# Range GETs across chunk boundaries, in each of the two read passes
FILER_RANGES = 20
# the 4 shards lost on shard 0's holder: ec.encode spreads the 14 shards
# one each way in turn, so that server holds the even shards
FILER_LOST = (0, 2, 4, 6)


def filer_tree(seed: int, target: int) -> tuple[list[str], list[tuple]]:
    """Phase 12's tree made from `seed` up to `target` bytes, without
    writing it: its directories (relative, parents first) and its files
    (relative path, size). Nearly all files are uniform in FILER_SMALL,
    the rest log-uniform in FILER_LARGE; every directory holds a file,
    since filer.copy makes a directory only for the files under it."""
    rng = np.random.default_rng(seed)
    dirs: list[str] = []

    def grow(prefix: str, level: int) -> None:
        for i in range(FILER_FANOUT[level]):
            d = f"{prefix}{'abc'[level]}{i}"
            dirs.append(d)
            if level + 1 < len(FILER_FANOUT):
                grow(d + "/", level + 1)

    grow("", 0)
    n_small = max(len(dirs),
                  round(FILER_SMALL_PER_GIB * target / (1 << 30)))
    sizes = [int(s) for s in rng.integers(FILER_SMALL[0],
                                          FILER_SMALL[1] + 1, n_small)]
    total = sum(sizes)
    lo, hi = math.log(FILER_LARGE[0]), math.log(FILER_LARGE[1])
    while total < target:
        sizes.append(int(math.exp(rng.uniform(lo, hi))))
        total += sizes[-1]
    order = rng.permutation(len(sizes))
    where = np.concatenate([np.arange(len(dirs)), rng.integers(
        0, len(dirs), len(sizes) - len(dirs))])
    files = [(f"{dirs[int(w)]}/f{i:05d}.bin", sizes[int(k)])
             for i, (k, w) in enumerate(zip(order, where))]
    return dirs, files


def write_filer_tree(seed: int, root: str, files: list[tuple]) -> dict:
    """Write the tree's files under `root` (contents from `seed`);
    returns each relative path's sha256."""
    rng = np.random.default_rng([seed, 12])
    shas = {}
    for rel, size in files:
        data = rng.bytes(size)
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        shas[rel] = hashlib.sha256(data).hexdigest()
    return shas


def chunk_sizes(size: int, chunk: int) -> list[int]:
    """The filer's chunks of a `size`-byte file (auto-chunking at
    -chunkSizeMB)."""
    return [chunk] * (size // chunk) + ([size % chunk] if size % chunk
                                        else [])


def filer_ranges(seed: int, files: list[tuple], chunk: int) -> list[tuple]:
    """FILER_RANGES (file index, first byte, last byte) that cross a chunk
    boundary of a multi-chunk file, from `seed`: the boundaries in turn,
    each range starting 1 B-256 KiB before its boundary and ending
    1 B-256 KiB after it."""
    rng = np.random.default_rng([seed, 13])
    bounds = [(i, b) for i, (_, size) in enumerate(files)
              for b in range(chunk, size, chunk)]
    check(bounds != [], "the tree has no file of more than one chunk")
    out = []
    for j in range(FILER_RANGES):
        i, b = bounds[j % len(bounds)]
        size = files[i][1]
        start = b - int(rng.integers(1, (256 << 10) + 1))
        end = min(size - 1, b + int(rng.integers(0, 256 << 10)))
        out.append((i, start, end))
    return out


def chunk_record_size(n: int) -> int:
    """On-disk bytes of one chunk the filer POSTs raw: data, flags and a
    last-modified time (no name, no mime for an octet-stream upload)."""
    from seaweedfs_tpu_torch.storage.needle import LAST_MODIFIED_BYTES
    return st.actual_size(4 + n + 1 + LAST_MODIFIED_BYTES,
                          st.CURRENT_VERSION)


def full_blocks_lost(offset: int, record: int, lost: tuple) -> int:
    """Small blocks (1 MiB, shard = block index mod 10) that a record at
    `offset` covers whole and that lie on a `lost` shard: its recovers at
    or above the 1 MiB -ec.smallrecover default."""
    first = -(-offset // pl.SMALL_BLOCK_SIZE)
    last = (offset + record) // pl.SMALL_BLOCK_SIZE
    return sum(1 for b in range(first, last)
               if b % gf.DATA_SHARDS in lost)


def record_recover_bounds(record: int, lost: tuple) -> tuple[int, int]:
    """The least and the most recovers of at least 1 MiB of one record
    over every offset it can have in a volume of small-block rows: the
    count changes only where the record's start or end crosses a block
    boundary, so those offsets (and 8 bytes either side) are enough."""
    row = gf.DATA_SHARDS * pl.SMALL_BLOCK_SIZE
    cands = {(base + d) % row for j in range(gf.DATA_SHARDS)
             for base in (j * pl.SMALL_BLOCK_SIZE,
                          j * pl.SMALL_BLOCK_SIZE - record)
             for d in (-8, 0, 8)}
    counts = [full_blocks_lost(o, record, lost) for o in cands]
    return min(counts), max(counts)


def filer_prediction(seed: int, target: int,
                     chunk: int = FILER_CHUNK_MB * MIB,
                     lost: tuple = FILER_LOST) -> dict:
    """Phase 12's K1 launches per step, reckoned on any host from the seed
    alone. Every chunk lands in the collection's one volume (the master
    grows one volume at a time and its limit is twice the tree), whose
    .dat size is the sum of the chunk records whatever their order:
    ec.encode's launches are its row batches, 8 a launch. The read passes
    before ec.encode and the listing, restart and shell steps launch
    nothing. The degraded passes recover each lost whole block of a
    chunk read; filer.copy uploads 8 files at a time, so a chunk's offset
    in the volume (and with it which blocks it covers whole) is not fixed
    by the seed, and those steps get the least and the most over every
    offset, (lo, hi)."""
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    _, files = filer_tree(seed, target)
    chunks = [chunk_sizes(size, chunk) for _, size in files]
    dat_size = SUPER_BLOCK_SIZE + sum(chunk_record_size(c)
                                      for cs in chunks for c in cs)
    bounds = {c: record_recover_bounds(chunk_record_size(c), lost)
              for cs in chunks for c in cs}

    def span(sizes: list[int]) -> tuple[int, int]:
        return (sum(bounds[c][0] for c in sizes),
                sum(bounds[c][1] for c in sizes))

    ranged = []
    for i, start, end in filer_ranges(seed, files, chunk):
        cs = chunks[i]
        ranged += cs[start // chunk:end // chunk + 1]
    return {"ingest": 0, "listing": 0, "GET intact": 0,
            "Range intact": 0,
            "ec.encode": batched_generate_launches(
                dat_size, pl.LARGE_BLOCK_SIZE, pl.SMALL_BLOCK_SIZE),
            "restart": 0,
            "GET degraded": span([c for cs in chunks for c in cs]),
            "Range degraded": span(ranged),
            "fs.du": 0, "fs.meta.notify": 0}


def within_prediction(launches: dict, predicted: dict) -> bool:
    """Each step's launches equal its predicted count, or lie in its
    predicted (lo, hi)."""
    if set(launches) != set(predicted):
        return False
    for step, want in predicted.items():
        got = launches[step]
        if isinstance(want, tuple):
            if not want[0] <= got <= want[1]:
                return False
        elif got != want:
            return False
    return True


def phase_filer(dev: torch.device, seed: int, target: int, *,
                card: str = "", backend: str = "gpu",
                chunk_mb: int = FILER_CHUNK_MB) -> dict:
    """The filer tier over the port's own cluster, no module of
    seaweedfs_tpu in any of its processes: a port master (cli.start_master,
    its volume limit twice the tree), two port volume servers
    (cli.start_volume, -ecBackend <backend>) and one port filer
    (cli.start_filer at the CLI defaults, -chunkSizeMB `chunk_mb`, a
    collection of its own) in this process. A tree made from `seed` up to
    `target` bytes goes in through `cli filer.copy` in a subprocess; every
    directory is listed, every file read (sha256) and FILER_RANGES Range
    GETs across chunk boundaries run; ec.encode -collection encodes the
    chunks' volume; 4 shards of one server are lost; the filer restarts
    on its sqlite store with a cold chunk cache; every file and the same
    ranges are read again, the degraded chunks recovered by K1; fs.du and
    fs.meta.notify run through the shell, and /cluster/shards answers.
    Returns the launch counts, what the .ecx says they must be and the
    timings."""
    import asyncio
    run_dir = os.path.join(FILER_DIR, "run")
    shutil.rmtree(FILER_DIR, ignore_errors=True)
    for d in ("m", "v0", "v1", "src"):
        os.makedirs(os.path.join(run_dir, d))
    try:
        return asyncio.run(_drive_filer(dev, seed, target, run_dir, card,
                                        backend, chunk_mb))
    finally:
        shutil.rmtree(FILER_DIR, ignore_errors=True)


async def _drive_filer(dev: torch.device, seed: int, target: int,
                       run_dir: str, card: str, backend: str,
                       chunk_mb: int) -> dict:
    import asyncio
    import aiohttp
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.notification.queues import FileQueue
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.shell.runner import dispatch

    tag = f"[{card}]" if card else ""
    launches, expected, timing = {}, {}, {}
    chunk = chunk_mb * MIB
    parser = cli.build_parser()
    dirs, files = filer_tree(seed, target)
    src = os.path.join(run_dir, "src", "tree")
    t0 = time.perf_counter()
    shas = await asyncio.get_running_loop().run_in_executor(
        None, write_filer_tree, seed, src, files)
    timing["make tree"] = time.perf_counter() - t0
    total = sum(size for _, size in files)
    ranges = filer_ranges(seed, files, chunk)
    root = "/data/tree"

    async def counted(step: str, coro):
        gf256_cuda.launches = 0
        t0 = time.perf_counter()
        out = await coro
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = gf256_cuda.launches
        return out

    filer_argv = ["filer", "-port", "0", "-store", "sqlite", "-dbPath",
                  os.path.join(run_dir, "filer.db"), "-chunkSizeMB",
                  str(chunk_mb), "-cache.mem", "64", "-collection",
                  FILER_COLLECTION]
    limit_mb = 2 * -(-target // MIB)
    master, mrec = await cli.start_master(parser.parse_args(
        cluster_master_args(run_dir, limit_mb)))
    servers, recs, filers = [], [mrec], []
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
    try:
        for i in range(2):
            vs, rec = await cli.start_volume(parser.parse_args(
                server_args(backend, os.path.join(run_dir, f"v{i}"),
                            master=master.url)
                + ["-max", str(CLUSTER_MAX_VOLUMES)]))
            servers.append(vs)
            recs.append(rec)
            check(await vs.heartbeat_once(),
                  f"volume server {vs.url} not registered with the master")
        fs, rec = await cli.start_filer(parser.parse_args(
            filer_argv + ["-master", master.url]))
        filers.append(fs)
        recs.append(rec)

        async def read_file(rel: str) -> float:
            """GET one file through the filer, sha256-equal to the tree's;
            returns its seconds."""
            h = hashlib.sha256()
            t0 = time.perf_counter()
            async with http.get(f"http://{fs.url}{root}/{rel}") as r:
                status = r.status
                async for block in r.content.iter_chunked(1 << 20):
                    h.update(block)
            check(status == 200 and h.hexdigest() == shas[rel],
                  f"GET {root}/{rel}: status {status}, sha256 differs "
                  f"from the file written")
            return time.perf_counter() - t0

        async def read_all() -> list[float]:
            return [await read_file(rel) for rel, _ in files]

        async def read_range(i: int, start: int, end: int) -> None:
            rel = files[i][0]
            with open(os.path.join(src, rel), "rb") as f:
                f.seek(start)
                want = f.read(end - start + 1)
            async with http.get(f"http://{fs.url}{root}/{rel}",
                                headers={"Range": f"bytes={start}-{end}"}
                                ) as r:
                body = await r.read()
                check(r.status == 206 and body == want,
                      f"Range {start}-{end} of {rel}: status {r.status}, "
                      f"{len(body)} bytes, expected {len(want)}")

        async def shell(command: str):
            async with CommandEnv(master.url, http) as env:
                return await dispatch(env, command)

        # -- 1. ingest through `cli filer.copy` in a subprocess
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

        async def ingest():
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-X", "importtime", "-m",
                "seaweedfs_tpu_torch.cli", "filer.copy", src,
                f"http://{fs.url}/data/", cwd=ROOT, env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            try:
                out, err = await asyncio.wait_for(proc.communicate(), 900)
            except BaseException:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
                raise
            err_text = err.decode(errors="replace")
            check(proc.returncode == 0, f"filer.copy: exit "
                  f"{proc.returncode}: {out.decode()[-1000:]} "
                  f"{err_text[-2000:]}")
            bad = forbidden_imports(err_text)
            check(bad == [], f"filer.copy imported {bad[:5]}")
            check("import time:" in err_text,
                  "the filer.copy subprocess printed no -X importtime log")
            return out.decode()

        out = await counted("ingest", ingest())
        check(f"copied {len(files)} files" in out, f"filer.copy: {out}")
        t = timing["ingest"]
        print(f"  ingest (cli filer.copy -concurrency 8 in a subprocess, "
              f"no jax or seaweedfs_tpu imported): {len(files)} files in "
              f"{len(dirs)} directories, {total} bytes in {t:.3f} s "
              f"({total / t / 1e6:.1f} MB/s, {len(files) / t:.1f} "
              f"files/s) {tag}")

        # -- 2. every directory listed, equal to the tree
        async def list_all() -> dict:
            entries = {}
            for d in [""] + dirs:
                path = root + ("/" + d if d else "")
                async with http.get(f"http://{fs.url}{path}",
                                    params={"limit": "100000"}) as r:
                    body = await r.json()
                    check(r.status == 200, f"list {path}: {r.status}")
                got = {(e["FullPath"], e["IsDirectory"],
                        e["FileSize"] if not e["IsDirectory"] else 0)
                       for e in body["Entries"]}
                want = {(f"{root}/{x}", True, 0) for x in dirs
                        if posixpath.dirname(x) == d}
                want |= {(f"{root}/{rel}", False, size)
                         for rel, size in files
                         if posixpath.dirname(rel) == d}
                check(got == want, f"listing of {path} differs from the "
                      f"tree: {sorted(got ^ want)[:4]}")
                for e in body["Entries"]:
                    entries[e["FullPath"]] = e
            return entries

        entries = await counted("listing", list_all())
        print(f"  listing: {len(dirs) + 1} directories, each equal to the "
              f"tree, in {timing['listing']:.3f} s {tag}")
        fids = {rel: [c["file_id"] for c in sorted(
            entries[f"{root}/{rel}"]["chunks"], key=lambda c: c["offset"])]
            for rel, _ in files}
        check(all(len(fids[rel]) == len(chunk_sizes(size, chunk))
                  for rel, size in files),
              "a file's chunk count differs from its size over the "
              "chunk size")
        vids = {int(fid.split(",")[0]) for fl in fids.values() for fid in fl}
        check(len(vids) == 1, f"the chunks landed in volumes {vids}, "
              f"expected one")
        vid = next(iter(vids))

        # -- 3. every file and the Range GETs, intact
        lat_a = await counted("GET intact", read_all())

        async def read_ranges():
            for i, start, end in ranges:
                await read_range(i, start, end)

        await counted("Range intact", read_ranges())

        # -- 4. ec.encode -collection through the port's shell
        from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
        for vs in servers:
            await vs.heartbeat_once()
        source = next(vs for vs in servers if vid in vs.store.volumes)
        dat_size = os.path.getsize(os.path.join(
            source.store.dirs[0], f"{FILER_COLLECTION}_{vid}.dat"))
        reckoned = SUPER_BLOCK_SIZE + sum(
            chunk_record_size(c) for _, size in files
            for c in chunk_sizes(size, chunk))
        check(dat_size == reckoned, f"volume {vid}'s .dat holds {dat_size} "
              f"bytes; the chunk records of the tree sum to {reckoned}")
        res = await counted("ec.encode", shell(
            f"ec.encode -collection {FILER_COLLECTION} -fullPercent 0"))
        check(isinstance(res, list) and [r["volume"] for r in res]
              == [vid], f"ec.encode answered {res}, expected volume {vid}")
        spread = {u: sorted(s) for u, s in res[0]["assignments"].items()}
        for vs in servers:
            await vs.heartbeat_once()
        owner = next(vs for vs in servers if vid in vs.store.ec_volumes
                     and 0 in vs.store.ec_volumes[vid].shards)
        base = os.path.join(owner.store.dirs[0],
                            f"{FILER_COLLECTION}_{vid}")
        expected["ec.encode"] = batched_generate_launches(
            dat_size, source.store.ec_large_block,
            source.store.ec_small_block)
        print(f"  ec.encode -collection {FILER_COLLECTION} (the port's "
              f"shell): volume {vid}, .dat {dat_size} bytes (the tree's "
              f"chunk records, as reckoned), {timing['ec.encode']:.3f} s, "
              f"shards {spread} {tag}")

        # -- 5. 4 shards of shard 0's holder lost
        lost = spread[owner.url][:4]
        check(tuple(lost) == FILER_LOST, f"shard 0's holder {owner.url} "
              f"holds {spread[owner.url]}; the prediction loses "
              f"{FILER_LOST}")
        arg = ",".join(map(str, lost))
        for path in ("/admin/ec/unmount", "/admin/ec/delete_shards"):
            async with http.post(f"http://{owner.url}{path}",
                                 params={"volume": str(vid),
                                         "collection": FILER_COLLECTION,
                                         "shards": arg}) as r:
                check(r.status == 200, f"POST {path}: {r.status} "
                      f"{await r.text()}")
        check(not any(os.path.exists(base + pl.to_ext(s)) for s in lost),
              f"lost shard files {lost} still on {owner.url}")
        for vs in servers:
            vs.store.drop_cached_volume(vid)
            vs.store.ec_recover_cache.drop_volume(vid)
            await vs.heartbeat_once()

        # -- 6. the filer restarts on its sqlite store
        async def restart():
            await fs.stop()
            return await cli.start_filer(parser.parse_args(
                filer_argv + ["-master", master.url]))

        fs, rec = await counted("restart", restart())
        filers.append(fs)
        recs.append(rec)
        print(f"  filer restart on the same sqlite -dbPath: "
              f"{timing['restart']:.3f} s {tag}")

        # -- 7. every file and the same ranges, degraded
        present = next(s for s in range(gf.TOTAL_SHARDS) if s not in lost)
        holder = next(vs for vs in servers if vid in vs.store.ec_volumes
                      and present in vs.store.ec_volumes[vid].shards)
        hbase = os.path.join(holder.store.dirs[0],
                             f"{FILER_COLLECTION}_{vid}")
        nid_of = {fid: st.FileId.parse(fid).key
                  for fl in fids.values() for fid in fl}
        ivs = lost_intervals(hbase, lost, holder.store.ec_large_block,
                             holder.store.ec_small_block,
                             list(nid_of.values()))
        for vs in servers:
            check_cache_cold(vs.store, dict.fromkeys(nid_of.values()),
                             ivs, vid)
        cc = fs.client.chunk_cache
        check(not any(cc.contains(fid) for fid in nid_of),
              "the restarted filer's chunk cache is not cold")
        threshold = holder.store.ec_volumes[vid].small_recover_bytes
        big = Counter(iv[0] for iv in ivs if iv[3] >= threshold)
        lat_b = await counted("GET degraded", read_all())
        expected["GET degraded"] = sum(big.values())

        async def read_ranges_cold():
            """Each range with the caches emptied first: the filer's of
            the range's chunks, the servers' of the volume."""
            for i, start, end in ranges:
                for fid in fids[files[i][0]]:
                    cc.delete(fid)
                for vs in servers:
                    vs.store.drop_cached_volume(vid)
                    vs.store.ec_recover_cache.drop_volume(vid)
                await read_range(i, start, end)

        await counted("Range degraded", read_ranges_cold())
        expected["Range degraded"] = sum(
            big[nid_of[fid]] for i, start, end in ranges
            for fid in fids[files[i][0]][start // chunk:end // chunk + 1])
        host_n, card_n = split_at(ivs, threshold)
        print(f"  degraded: shards {lost} lost on {owner.url}, {len(ivs)} "
              f"intervals on them: {host_n} under the {threshold}-byte "
              f"threshold (host), {card_n} at or above it (K1); every file "
              f"and {len(ranges)} ranges sha256-equal {tag}")
        for name, lat in (("intact", lat_a), ("degraded", lat_b)):
            print(f"  GET {name} through the filer: {len(lat)} files in "
                  f"{sum(lat):.3f} s, latency p50 "
                  f"{percentile_ms(lat, 50):.4f} ms, p99 "
                  f"{percentile_ms(lat, 99):.4f} ms {tag}")

        # -- 8. fs.du and fs.meta.notify through the shell
        du = await counted("fs.du", shell(f"fs.du -filer {fs.url} "
                                          f"-path {root}"))
        check(du == {"path": root, "files": len(files), "dirs": len(dirs),
                     "bytes": total}, f"fs.du answered {du}")
        ls = await shell(f"fs.ls -filer {fs.url} -path {root}")
        check(ls == [d + "/" for d in dirs if "/" not in d],
              f"fs.ls {root} answered {ls}")
        qpath = os.path.join(run_dir, "notify.q")
        note = await counted("fs.meta.notify", shell(
            f"fs.meta.notify -filer {fs.url} -path {root} "
            f"-notify file:{qpath}"))
        msgs, _ = FileQueue(qpath).read_from(0)
        check(note == {"notified_dirs": len(dirs),
                       "notified_files": len(files)}
              and len(msgs) == len(dirs) + len(files),
              f"fs.meta.notify answered {note} with {len(msgs)} events")
        for step in ("ingest", "listing", "GET intact", "Range intact",
                     "restart", "fs.du", "fs.meta.notify"):
            expected[step] = 0

        # -- 9. the master's shard map answers
        async with http.get(f"http://{master.url}/cluster/shards") as r:
            body = await r.json()
            check(r.status == 200 and "epoch" in body,
                  f"GET /cluster/shards: {r.status} {body}")
        print(f"  wall seconds per step: "
              f"{ {k: round(v, 4) for k, v in timing.items()} } {tag}")
        print(f"  filer path kernel launches per step: {launches} {tag}")
    finally:
        await http.close()
        if filers:
            await filers[-1].stop()
        for vs in servers:
            await vs.stop()
        await master.stop()
        for rec in recs:
            if rec is not None:
                rec.cancel()
    return {"launches": launches, "expected": expected, "timing": timing,
            "files": len(files), "intervals": len(ivs),
            "split": (host_n, card_n), "lost": lost, "volume": vid,
            "dat_size": dat_size}


GATEWAY_DIR = os.path.join(ROOT, ".smoke_gateway")
# buckets (each its own collection) of the combined server's anonymous S3,
# of the signed standalone gateway and of its refused upload, and the
# WebDAV gateway's collection
GATEWAY_BUCKET = "gw13"
GATEWAY_SIGNED_BUCKET = "gw13-signed"
GATEWAY_TAMPER_BUCKET = "gw13-tamper"
GATEWAY_DAV_COLLECTION = "gw13dav"
# boto3's default multipart_threshold and multipart_chunksize, what aws-cli
# users send: objects of this size or more go in parts of this size
S3_PART = 8 * MIB
# S3Gateway's chunk_size (seaweedfs_tpu/s3/gateway.py:80), which neither
# the s3 nor the server subcommand sets
S3_CHUNK = 8 * MIB
# the webdav subcommand's -chunkSizeMB default
DAV_CHUNK_MB = 16
# the signed set: small objects by header auth over a signed payload hash,
# large ones (uniform in the range) by aws-chunked streaming in 64 KiB
# chunks; the WebDAV set: small and large files of the tree's size mix.
# Both are cut in half from (200, 8) and (500, 8), which took the script
# past 420 s on the H100 (PERF.md section 4)
GATEWAY_SIGNED = (100, 4)
GATEWAY_SIGNED_LARGE = (8 * MIB, 32 * MIB)
GATEWAY_DAV = (250, 4)
AWS_CHUNK = 64 << 10
GATEWAY_KEY, GATEWAY_SECRET = "GW13ACCESSKEY", "GW13SECRETKEY"
GATEWAY_REGION = "us-east-1"


def object_bytes(seed: int, tag: int, i: int, size: int) -> bytes:
    """The bytes of object i of a set, from `seed` alone."""
    return np.random.default_rng([seed, tag, i]).bytes(size)


def signed_objects(seed: int, counts: tuple = GATEWAY_SIGNED,
                   large: tuple = GATEWAY_SIGNED_LARGE) -> list[tuple]:
    """Phase 13's signed set from `seed`: (key, size, streamed), the small
    objects uniform in FILER_SMALL, the large uniform in `large` and sent
    aws-chunked."""
    rng = np.random.default_rng([seed, 15])
    small = rng.integers(FILER_SMALL[0], FILER_SMALL[1] + 1, counts[0])
    big = rng.integers(large[0], large[1] + 1, counts[1])
    return ([(f"s/o{i:04d}.bin", int(s), False) for i, s in enumerate(small)]
            + [(f"l/o{i:04d}.bin", int(s), True) for i, s in enumerate(big)])


def dav_files(seed: int, dirs: list[str], counts: tuple = GATEWAY_DAV
              ) -> list[tuple]:
    """Phase 13's WebDAV set from `seed`: (path, size), small files
    uniform in FILER_SMALL and large ones log-uniform in FILER_LARGE, as
    the tree's, spread over the tree's directories."""
    rng = np.random.default_rng([seed, 16])
    sizes = [int(s) for s in rng.integers(FILER_SMALL[0], FILER_SMALL[1] + 1,
                                          counts[0])]
    lo, hi = np.log(FILER_LARGE[0]), np.log(FILER_LARGE[1])
    sizes += [int(np.exp(v)) for v in rng.uniform(lo, hi, counts[1])]
    where = rng.integers(0, len(dirs), len(sizes))
    return [(f"/{dirs[int(w)]}/w{i:04d}.bin", s)
            for i, (s, w) in enumerate(zip(sizes, where))]


def s3_chunks(size: int, part: int) -> list[int]:
    """The chunks of one gw13 object: one PUT (one chunk) under `part`
    bytes, else one chunk per part."""
    return chunk_sizes(size, part) if size >= part else [size]


def chunks_etag(datas: list[bytes]) -> str:
    """filechunks.etag of chunks holding these bytes: a chunk's etag is
    its CRC32C in hex (the volume server's eTag), several chunks' the MD5
    of their etags."""
    from seaweedfs_tpu_torch.util.crc32c import crc32c
    tags = ["%08x" % crc32c(d) for d in datas]
    if len(tags) == 1:
        return tags[0]
    return hashlib.md5("".join(tags).encode()).hexdigest()


def gateway_prediction(seed: int, target: int, *, part: int = S3_PART,
                       signed: tuple = GATEWAY_SIGNED,
                       signed_large: tuple = GATEWAY_SIGNED_LARGE,
                       dav: tuple = GATEWAY_DAV,
                       dav_chunk: int = DAV_CHUNK_MB * MIB,
                       lost: tuple = FILER_LOST) -> dict:
    """Phase 13's K1 launches per step, reckoned on any host from the seed
    alone. Each collection's chunks land in its one volume (the combined
    master keeps its 30,000 MB limit), whose .dat size is the sum of the
    chunk records in any order: each ec.encode is exact. The writes and
    the intact reads launch nothing. The degraded passes recover each
    lost whole block of every chunk they read, and uploads run 8 at a
    time, so a chunk's offset in its volume is not fixed by the seed:
    those steps get the least and the most over every offset."""
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    dirs, files = filer_tree(seed, target)
    gw = [s3_chunks(size, part) for _, size in files]
    sg = [chunk_sizes(size, S3_CHUNK) for _, size, _ in
          signed_objects(seed, signed, signed_large)]
    dv = [chunk_sizes(size, dav_chunk) for _, size in
          dav_files(seed, dirs, dav)]
    bounds: dict[int, tuple] = {}

    def span(sizes: list[int]) -> tuple[int, int]:
        for c in sizes:
            if c not in bounds:
                bounds[c] = record_recover_bounds(chunk_record_size(c), lost)
        return (sum(bounds[c][0] for c in sizes),
                sum(bounds[c][1] for c in sizes))

    def encode(chunk_lists: list[list[int]]) -> int:
        dat = SUPER_BLOCK_SIZE + sum(chunk_record_size(c)
                                     for cs in chunk_lists for c in cs)
        return batched_generate_launches(dat, pl.LARGE_BLOCK_SIZE,
                                         pl.SMALL_BLOCK_SIZE)

    ranged = []
    for i, start, end in filer_ranges(seed, files, part):
        ranged += gw[i][start // part:end // part + 1]
    every = [c for cs in gw for c in cs]
    out = dict.fromkeys(GATEWAY_QUIET_STEPS, 0)
    out.update({
        f"ec.encode {GATEWAY_BUCKET}": encode(gw),
        f"ec.encode {GATEWAY_SIGNED_BUCKET}": encode(sg),
        f"ec.encode {GATEWAY_DAV_COLLECTION}": encode(dv),
        "S3 GET degraded": span(every),
        "S3 Range degraded": span(ranged),
        "signed GET degraded": span([c for cs in sg for c in cs]),
        "WebDAV GET degraded": span([c for cs in dv for c in cs]),
        "filer.replicate": span(every)})
    return out


# the steps of phase 13 that launch nothing
GATEWAY_QUIET_STEPS = ("S3 PUT", "S3 listing", "S3 GET intact",
                       "S3 Range intact", "signed PUT", "signed refusals",
                       "WebDAV PUT", "WebDAV PROPFIND", "WebDAV MOVE",
                       "WebDAV GET intact", "restarts")


def sign_v4(method: str, host: str, path: str, payload_hash: str,
            secret: str = GATEWAY_SECRET) -> dict:
    """SigV4 header auth as an SDK signs a request (host, x-amz-date and
    x-amz-content-sha256 signed), from the port's s3/auth.py primitives."""
    import hmac
    from seaweedfs_tpu_torch.s3 import auth
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    headers = {"host": host, "x-amz-date": amz_date,
               "x-amz-content-sha256": payload_hash}
    signed = sorted(headers)
    canon = "\n".join([method, path, "",
                       "".join(f"{h}:{headers[h]}\n" for h in signed),
                       ";".join(signed), payload_hash])
    scope = f"{date}/{GATEWAY_REGION}/s3/aws4_request"
    sts = "\n".join([auth.ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    sig = hmac.new(auth.signing_key(secret, date, GATEWAY_REGION),
                   sts.encode(), hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"{auth.ALGORITHM} Credential={GATEWAY_KEY}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return headers


def aws_chunked(headers: dict, data: bytes, secret: str = GATEWAY_SECRET,
                tamper_last: bool = False) -> bytes:
    """`data` framed as STREAMING-AWS4-HMAC-SHA256-PAYLOAD in AWS_CHUNK
    chunks, each signed in the chain seeded by the request's signature
    (AuthContext.chunk_signature); with tamper_last the last data chunk's
    signature is wrong."""
    from seaweedfs_tpu_torch.s3 import auth
    seed_sig = headers["Authorization"].split("Signature=")[1]
    amz_date = headers["x-amz-date"]
    scope = f"{amz_date[:8]}/{GATEWAY_REGION}/s3/aws4_request"
    ctx = auth.AuthContext(GATEWAY_KEY, auth.signing_key(
        secret, amz_date[:8], GATEWAY_REGION), scope, amz_date, seed_sig,
        "")
    pieces = [data[i:i + AWS_CHUNK] for i in range(0, len(data), AWS_CHUNK)]
    out, prev = [], seed_sig
    for j, piece in enumerate(pieces + [b""]):
        prev = ctx.chunk_signature(prev, piece)
        sig = prev
        if tamper_last and j == len(pieces) - 1:
            sig = "0" * len(prev)
        out.append(f"{len(piece):x};chunk-signature={sig}\r\n".encode()
                   + piece + b"\r\n")
    return b"".join(out)


def presign_get(host: str, path: str, expires: int = 3600) -> dict:
    """The query of a presigned GET (X-Amz-* parameters, host signed)."""
    import hmac
    import urllib.parse
    from seaweedfs_tpu_torch.s3 import auth
    amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    date = amz_date[:8]
    scope = f"{date}/{GATEWAY_REGION}/s3/aws4_request"
    q = {"X-Amz-Algorithm": auth.ALGORITHM,
         "X-Amz-Credential": f"{GATEWAY_KEY}/{scope}",
         "X-Amz-Date": amz_date, "X-Amz-Expires": str(expires),
         "X-Amz-SignedHeaders": "host"}
    cq = "&".join(f"{urllib.parse.quote(k, safe='-_.~')}="
                  f"{urllib.parse.quote(v, safe='-_.~')}"
                  for k, v in sorted(q.items()))
    canon = "\n".join(["GET", path, cq, f"host:{host}\n", "host",
                       auth.UNSIGNED])
    sts = "\n".join([auth.ALGORITHM, amz_date, scope,
                     hashlib.sha256(canon.encode()).hexdigest()])
    q["X-Amz-Signature"] = hmac.new(
        auth.signing_key(GATEWAY_SECRET, date, GATEWAY_REGION),
        sts.encode(), hashlib.sha256).hexdigest()
    return q


class CliProcess:
    """`python -X importtime -m seaweedfs_tpu_torch.cli ...` as a child
    of this event loop: its importtime log goes to a file (a pipe would
    fill and stall it), its stdout to a pipe."""

    def __init__(self, name: str, args: list[str], log_dir: str):
        self.name, self.args = name, args
        self.log = os.path.join(log_dir, f"{name}.importtime")
        self.proc = None

    async def spawn(self) -> None:
        import asyncio
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        with open(self.log, "w") as err:
            self.proc = await asyncio.create_subprocess_exec(
                sys.executable, "-X", "importtime", "-m",
                "seaweedfs_tpu_torch.cli", *self.args, cwd=ROOT, env=env,
                stdout=asyncio.subprocess.PIPE, stderr=err)

    async def start(self, ready: str, timeout: float = 120.0) -> str:
        """Spawn it and return group 1 of its first stdout line that
        matches `ready`."""
        import asyncio
        await self.spawn()

        async def wait_line() -> str:
            while True:
                line = (await self.proc.stdout.readline()).decode()
                if line == "":
                    rc = await self.proc.wait()
                    check(False, f"{self.name} exited {rc} before it was "
                          f"ready: {self.tail()}")
                m = re.search(ready, line)
                if m:
                    return m.group(1)

        try:
            return await asyncio.wait_for(wait_line(), timeout)
        except BaseException:
            await self.kill()
            raise

    async def run(self, timeout: float = 900.0) -> str:
        """Spawn it and wait for its end; returns its stdout. It must
        exit 0 and import nothing of jax or seaweedfs_tpu."""
        import asyncio
        await self.spawn()
        try:
            out, _ = await asyncio.wait_for(self.proc.communicate(), timeout)
        except BaseException:
            await self.kill()
            raise
        check(self.proc.returncode == 0, f"{self.name}: exit "
              f"{self.proc.returncode}: {out.decode()[-1000:]} "
              f"{self.tail()}")
        self.check_imports()
        return out.decode()

    def tail(self) -> str:
        """The end of its standard error, less the importtime lines."""
        with open(self.log, errors="replace") as f:
            return "".join(line for line in f
                           if not line.startswith("import time:"))[-2000:]

    async def stop(self) -> None:
        """SIGINT, then the exit code must be 0 and the importtime log
        must list no module of jax or seaweedfs_tpu."""
        import asyncio
        import signal
        self.proc.send_signal(signal.SIGINT)
        try:
            rc = await asyncio.wait_for(self.proc.wait(), 60)
        except asyncio.TimeoutError:
            await self.kill()
            rc = None
        check(rc == 0, f"{self.name} exited {rc} on SIGINT: {self.tail()}")
        self.check_imports()

    def check_imports(self) -> None:
        with open(self.log, errors="replace") as f:
            text = f.read()
        check("import time:" in text,
              f"{self.name} printed no -X importtime log")
        bad = forbidden_imports(text)
        check(bad == [], f"{self.name} imported {bad[:5]}")

    async def kill(self) -> None:
        if self.proc is not None and self.proc.returncode is None:
            self.proc.kill()
            await self.proc.wait()


def phase_gateway(dev: torch.device, seed: int, target: int, *,
                  card: str = "", part: int = S3_PART,
                  signed: tuple = GATEWAY_SIGNED,
                  signed_large: tuple = GATEWAY_SIGNED_LARGE,
                  dav: tuple = GATEWAY_DAV,
                  dav_chunk_mb: int = DAV_CHUNK_MB) -> dict:
    """The gateways over the port's combined server, no module of
    seaweedfs_tpu in any of its processes: `server -filer -s3` through
    cli.start_server in this process, with a SqliteQueue on its filer; the
    tree of phase 12 (from `seed`, `target` bytes) PUT as objects of bucket
    gw13 through its anonymous S3 (multipart at `part` bytes), listed,
    read and ranged; a signed set through a standalone `cli s3` subprocess
    (header auth, aws-chunked streaming, a wrong secret and a tampered
    chunk refused); a WebDAV set through a `cli webdav` subprocess (MKCOL,
    PUT, PROPFIND, MOVE, GET); ec.encode of each collection through `cli
    shell -c`; shards {0,2,4,6} lost; both gateways restarted cold; every
    object, range and file read again and the tree replicated by `cli
    filer.replicate -once`, the degraded chunks recovered by K1 in this
    process. Returns the launches, what the .ecx says they must be, and
    the timings."""
    import asyncio
    shutil.rmtree(GATEWAY_DIR, ignore_errors=True)
    os.makedirs(os.path.join(GATEWAY_DIR, "logs"))
    try:
        return asyncio.run(_drive_gateway(
            dev, seed, target, card, part, signed, signed_large, dav,
            dav_chunk_mb))
    finally:
        shutil.rmtree(GATEWAY_DIR, ignore_errors=True)


async def _drive_gateway(dev, seed, target, card, part, signed,
                         signed_large, dav, dav_chunk_mb) -> dict:
    import asyncio
    import urllib.parse
    import xml.etree.ElementTree as ET
    import aiohttp
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.notification.queues import (SqliteQueue,
                                                         attach_to_filer)
    from seaweedfs_tpu_torch.s3 import auth
    from seaweedfs_tpu_torch.storage.needle_map import walk_index_blob
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE

    check(part <= S3_CHUNK, f"parts of {part} bytes would span chunks")
    tag = f"[{card}]" if card else ""
    logs = os.path.join(GATEWAY_DIR, "logs")
    loop = asyncio.get_running_loop()
    launches, expected, timing = {}, {}, {}
    dav_chunk = dav_chunk_mb * MIB
    dirs, files = filer_tree(seed, target)
    sobjs = signed_objects(seed, signed, signed_large)
    dfiles = dav_files(seed, dirs, dav)
    ranges = filer_ranges(seed, files, part)
    total = sum(size for _, size in files)

    async def counted(step: str, coro):
        gf256_cuda.launches = 0
        t0 = time.perf_counter()
        out = await coro
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = gf256_cuda.launches
        return out

    def in_thread(fn, *args):
        return loop.run_in_executor(None, fn, *args)

    ports = {k: free_port() for k in ("master", "volume", "filer", "s3",
                                      "s3alone", "dav")}
    parser = cli.build_parser()
    up, rec = await cli.start_server(parser.parse_args([
        "server", "-dir", os.path.join(GATEWAY_DIR, "server"), "-filer",
        "-s3", "-masterPort", str(ports["master"]), "-volumePort",
        str(ports["volume"]), "-filerPort", str(ports["filer"]),
        "-s3Port", str(ports["s3"])]))
    master, vs, s3 = up["master"], up["volume"], up["s3"]
    qpath = os.path.join(GATEWAY_DIR, "events.db")
    queue = SqliteQueue(qpath)
    attach_to_filer(up["filer"].filer, queue)
    check(master.volume_size_limit == 30_000 * 1024 * 1024,
          f"the combined master's volume limit is "
          f"{master.volume_size_limit} bytes, not its 30,000 MB default")
    s3alone = CliProcess("s3", [
        "s3", "-port", str(ports["s3alone"]), "-master", master.url,
        "-store", "sqlite", "-dbPath", os.path.join(GATEWAY_DIR, "s3.db"),
        "-accessKey", GATEWAY_KEY, "-secretKey", GATEWAY_SECRET], logs)
    davp = CliProcess("webdav", [
        "webdav", "-port", str(ports["dav"]), "-master", master.url,
        "-store", "sqlite", "-dbPath", os.path.join(GATEWAY_DIR, "dav.db"),
        "-collection", GATEWAY_DAV_COLLECTION, "-chunkSizeMB",
        str(dav_chunk_mb)], logs)
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=900))
    sem = asyncio.Semaphore(8)
    s3url = f"http://{s3.url}"
    etags, shas = {}, {}
    try:
        alone = await s3alone.start(r"s3 gateway listening on (\S+)")
        dav_host = await davp.start(r"webdav listening on (\S+) ")

        # -- 2. anonymous S3 through the combined server
        async with http.put(f"{s3url}/{GATEWAY_BUCKET}") as r:
            check(r.status == 200, f"PUT bucket: {r.status}")

        def prepare(i: int, size: int) -> tuple:
            data = object_bytes(seed, 12, i, size)
            parts = [data[j:j + part] for j in range(0, size, part)] \
                if size >= part else [data]
            return (data, hashlib.sha256(data).hexdigest(),
                    hashlib.md5(data).hexdigest(),
                    [hashlib.md5(p).hexdigest() for p in parts],
                    chunks_etag(parts), parts)

        async def put_object(i: int, key: str, size: int) -> None:
            async with sem:
                data, sha, md5, part_md5, etag, parts = await in_thread(
                    prepare, i, size)
                url = f"{s3url}/{GATEWAY_BUCKET}/{key}"
                if size < part:
                    async with http.put(url, data=data) as r:
                        check(r.status == 200 and r.headers.get("ETag")
                              == f'"{md5}"', f"PUT {key}: {r.status} ETag "
                              f"{r.headers.get('ETag')}, expected the MD5")
                    etags[key] = f'"{etag}"'
                else:
                    async with http.post(url, params={"uploads": ""}) as r:
                        body = await r.read()
                        check(r.status == 200, f"initiate {key}: {r.status}")
                    uid = next(el.text for el in ET.fromstring(body).iter()
                               if el.tag.endswith("UploadId"))
                    for n, p in enumerate(parts, 1):
                        async with http.put(url, data=p, params={
                                "partNumber": str(n), "uploadId": uid}) as r:
                            check(r.status == 200 and r.headers.get("ETag")
                                  == f'"{part_md5[n - 1]}"',
                                  f"part {n} of {key}: {r.status}")
                    async with http.post(url, params={"uploadId": uid},
                                         data=b"<CompleteMultipartUpload/>"
                                         ) as r:
                        body = await r.read()
                        check(r.status == 200, f"complete {key}: {r.status}")
                    got = next(el.text for el in ET.fromstring(body).iter()
                               if el.tag.endswith("ETag"))
                    check(got == f'"{etag}-{len(parts)}"', f"complete "
                          f"{key}: ETag {got}, expected \"{etag}-"
                          f"{len(parts)}\"")
                    etags[key] = f'"{etag}"'
                shas[key] = sha

        await counted("S3 PUT", asyncio.gather(*(
            put_object(i, key, size) for i, (key, size) in enumerate(files))))
        t = timing["S3 PUT"]
        n_multi = sum(size >= part for _, size in files)
        print(f"  S3 PUT (anonymous, the combined server's gateway, 8 at a "
              f"time): {len(files)} objects ({n_multi} by multipart in "
              f"{part} B parts), {total} bytes in {t:.3f} s "
              f"({total / t / 1e6:.1f} MB/s, {len(files) / t:.1f} "
              f"objects/s); PUT, part and completion ETags as the "
              f"reference's gateway gives them {tag}")

        async def list_all() -> None:
            for d in [""] + dirs:
                prefix = d + "/" if d else ""
                async with http.get(f"{s3url}/{GATEWAY_BUCKET}", params={
                        "prefix": prefix, "delimiter": "/"}) as r:
                    body = await r.read()
                    check(r.status == 200, f"list {prefix}: {r.status}")
                root = ET.fromstring(body)
                got = {(el.findtext("{*}Key"), int(el.findtext("{*}Size")),
                        el.findtext("{*}ETag"))
                       for el in root.findall("{*}Contents")}
                want = {(k, size, etags[k]) for k, size in files
                        if posixpath.dirname(k) == d}
                check(got == want, f"listing of {prefix!r} differs from "
                      f"the tree: {sorted(got ^ want)[:3]}")
                pre = {el.findtext("{*}Prefix")
                       for el in root.findall("{*}CommonPrefixes")}
                check(pre == {x + "/" for x in dirs
                              if posixpath.dirname(x) == d},
                      f"common prefixes of {prefix!r}: {sorted(pre)[:4]}")

        await counted("S3 listing", list_all())

        async def get_object(key: str, url: str, **kw) -> float:
            h = hashlib.sha256()
            t0 = time.perf_counter()
            async with http.get(url, **kw) as r:
                status, etag = r.status, r.headers.get("ETag")
                async for block in r.content.iter_chunked(MIB):
                    h.update(block)
            check(status == 200 and h.hexdigest() == shas[key],
                  f"GET {key}: status {status}, sha256 differs")
            if key in etags:
                check(etag == etags[key], f"GET {key}: ETag {etag}, "
                      f"expected {etags[key]}")
            return time.perf_counter() - t0

        async def s3_get_all() -> list[float]:
            return [await get_object(
                key, f"{s3url}/{GATEWAY_BUCKET}/{key}") for key, _ in files]

        async def s3_range(i: int, start: int, end: int) -> None:
            key, size = files[i]
            want = (await in_thread(object_bytes, seed, 12, i, size))[
                start:end + 1]
            async with http.get(f"{s3url}/{GATEWAY_BUCKET}/{key}",
                                headers={"Range": f"bytes={start}-{end}"}
                                ) as r:
                body = await r.read()
                check(r.status == 206 and body == want
                      and r.headers.get("Content-Range")
                      == f"bytes {start}-{end}/{size}",
                      f"Range {start}-{end} of {key}: {r.status}, "
                      f"{len(body)} bytes")

        lat_a = await counted("S3 GET intact", s3_get_all())

        async def ranges_intact():
            for i, start, end in ranges:
                await s3_range(i, start, end)

        await counted("S3 Range intact", ranges_intact())

        # -- 3. signed S3 through the standalone gateway
        ahost = alone
        aurl = f"http://{ahost}"
        h = sign_v4("PUT", ahost, f"/{GATEWAY_SIGNED_BUCKET}", auth.UNSIGNED)
        async with http.put(f"{aurl}/{GATEWAY_SIGNED_BUCKET}",
                            headers=h) as r:
            check(r.status == 200, f"signed PUT bucket: {r.status} "
                  f"{await r.text()}")

        async def put_signed(i: int, key: str, size: int,
                             streamed: bool) -> None:
            async with sem:
                data = await in_thread(object_bytes, seed, 15, i, size)
                path = f"/{GATEWAY_SIGNED_BUCKET}/{key}"
                if streamed:
                    h = sign_v4("PUT", ahost, path, auth.STREAMING)
                    h["Content-Encoding"] = "aws-chunked"
                    h["x-amz-decoded-content-length"] = str(size)
                    body = await in_thread(aws_chunked, h, data)
                else:
                    h = sign_v4("PUT", ahost, path,
                                hashlib.sha256(data).hexdigest())
                    body = data
                async with http.put(aurl + path, headers=h, data=body) as r:
                    check(r.status == 200 and r.headers.get("ETag")
                          == f'"{hashlib.md5(data).hexdigest()}"',
                          f"signed PUT {key}: {r.status} {await r.text()}")
                shas[key] = hashlib.sha256(data).hexdigest()
                pieces = [data[j:j + S3_CHUNK]
                          for j in range(0, size, S3_CHUNK)]
                etags[key] = f'"{chunks_etag(pieces)}"'

        await counted("signed PUT", asyncio.gather(*(
            put_signed(i, key, size, streamed)
            for i, (key, size, streamed) in enumerate(sobjs))))
        sbytes = sum(size for _, size, _ in sobjs)
        print(f"  signed S3 PUT (standalone `cli s3`, SigV4 header auth; "
              f"{sum(s for _, _, s in sobjs)} aws-chunked in {AWS_CHUNK} B "
              f"chunks): {len(sobjs)} objects, {sbytes} bytes in "
              f"{timing['signed PUT']:.3f} s {tag}")

        async def refusals() -> None:
            path = f"/{GATEWAY_SIGNED_BUCKET}/refused.bin"
            h = sign_v4("PUT", ahost, path, auth.UNSIGNED, secret="WRONG")
            async with http.put(aurl + path, headers=h, data=b"x") as r:
                body = await r.read()
                check(r.status == 403
                      and b"<Code>SignatureDoesNotMatch</Code>" in body,
                      f"a wrong secret got {r.status} {body[:200]}")
            h = sign_v4("PUT", ahost, f"/{GATEWAY_TAMPER_BUCKET}",
                        auth.UNSIGNED)
            async with http.put(f"{aurl}/{GATEWAY_TAMPER_BUCKET}",
                                headers=h) as r:
                check(r.status == 200, f"PUT bucket: {r.status}")
            # over one gateway chunk, so the first chunk is stored before
            # the last signature fails
            size = S3_CHUNK + MIB
            data = await in_thread(object_bytes, seed, 17, 0, size)
            path = f"/{GATEWAY_TAMPER_BUCKET}/tampered.bin"
            h = sign_v4("PUT", ahost, path, auth.STREAMING)
            h["Content-Encoding"] = "aws-chunked"
            h["x-amz-decoded-content-length"] = str(size)
            body = await in_thread(lambda: aws_chunked(h, data,
                                                       tamper_last=True))
            async with http.put(aurl + path, headers=h, data=body) as r:
                text = await r.read()
                check(r.status == 403
                      and b"<Code>SignatureDoesNotMatch</Code>" in text,
                      f"a tampered chunk got {r.status} {text[:200]}")
            # the chunk stored before the failure is deleted (the
            # standalone gateway's chunk GC loop, once a second)
            vols = [v for v in vs.store.volumes.values()
                    if v.collection == GATEWAY_TAMPER_BUCKET]
            check(len(vols) == 1, f"{len(vols)} volumes of "
                  f"{GATEWAY_TAMPER_BUCKET}")
            nm = vols[0].nm
            for _ in range(100):
                if nm.file_count >= 1 and nm.deleted_count == nm.file_count:
                    break
                await asyncio.sleep(0.1)
            check(nm.file_count == 1 and nm.deleted_count == 1,
                  f"the tampered upload left {nm.file_count} chunks, "
                  f"{nm.deleted_count} deleted: expected its one stored "
                  f"chunk deleted; the gateway's log: {s3alone.tail()}")
            h = sign_v4("GET", ahost, path, auth.UNSIGNED)
            async with http.get(aurl + path, headers=h) as r:
                check(r.status == 404, f"GET of the refused object: "
                      f"{r.status}")

        await counted("signed refusals", refusals())
        print(f"  refused: a wrong secret (403 SignatureDoesNotMatch), a "
              f"tampered chunk signature (403, its stored chunk deleted) "
              f"{tag}")

        # -- 4. WebDAV
        durl = f"http://{dav_host}"

        async def dav_put() -> None:
            for d in dirs:
                async with http.request("MKCOL", f"{durl}/{d}") as r:
                    check(r.status == 201, f"MKCOL {d}: {r.status}")

            async def put(i: int, path: str, size: int) -> None:
                async with sem:
                    data = await in_thread(object_bytes, seed, 16, i, size)
                    async with http.put(durl + path, data=data) as r:
                        check(r.status == 201, f"PUT {path}: {r.status}")
                    shas[path] = hashlib.sha256(data).hexdigest()

            await asyncio.gather(*(put(i, p, s)
                                   for i, (p, s) in enumerate(dfiles)))

        await counted("WebDAV PUT", dav_put())
        dbytes = sum(s for _, s in dfiles)
        print(f"  WebDAV (`cli webdav -chunkSizeMB {dav_chunk_mb}`): MKCOL "
              f"{len(dirs)} directories, PUT {len(dfiles)} files, {dbytes} "
              f"bytes in {timing['WebDAV PUT']:.3f} s {tag}")

        def dav_tree(moved: tuple | None) -> tuple[list, list]:
            """Directories and files of the WebDAV tree, after `moved`
            (source, destination) when given."""
            def mv(p: str) -> str:
                if moved and (p == moved[0] or p.startswith(moved[0] + "/")):
                    return moved[1] + p[len(moved[0]):]
                return p
            return ([mv("/" + d) for d in dirs],
                    [(mv(p), s, p) for p, s in dfiles])

        async def propfind_all(moved=None) -> None:
            ds, fs = dav_tree(moved)
            for d in ["/"] + ds:
                async with http.request("PROPFIND", durl + d,
                                        headers={"Depth": "1"}) as r:
                    body = await r.read()
                    check(r.status == 207, f"PROPFIND {d}: {r.status}")
                got = {}
                for resp in ET.fromstring(body).findall("{DAV:}response"):
                    href = urllib.parse.unquote(resp.findtext("{DAV:}href"))
                    got[href] = resp.findtext(".//{DAV:}getcontentlength")
                me = d if d == "/" else d + "/"
                want = {me: None}
                want.update({x + "/": None for x in ds
                             if posixpath.dirname(x) == d})
                want.update({p: str(s) for p, s, _ in fs
                             if posixpath.dirname(p) == d})
                check(got == want, f"PROPFIND {d} differs from the tree: "
                      f"{sorted(set(got.items()) ^ set(want.items()))[:3]}")

        await counted("WebDAV PROPFIND", propfind_all())
        moved = ("/" + dirs[1], "/" + dirs[1] + "-moved")

        async def dav_move() -> None:
            async with http.request("MOVE", durl + moved[0], headers={
                    "Destination": durl + moved[1]}) as r:
                check(r.status == 201, f"MOVE {moved}: {r.status}")
            await propfind_all(moved)

        await counted("WebDAV MOVE", dav_move())
        _, dav_after = dav_tree(moved)

        async def dav_get_all() -> list[float]:
            return [await get_object(orig, durl + p)
                    for p, _, orig in dav_after]

        async def dav_get_intact() -> list[float]:
            lat = await dav_get_all()
            i = max(range(len(dav_after)), key=lambda j: dav_after[j][1])
            p, size, orig = dav_after[i]
            start = max(0, min(size - 1, dav_chunk) - 1000)
            end = min(size - 1, start + 300_000)
            data = await in_thread(object_bytes, seed, 16,
                                   dfiles.index((orig, size)), size)
            async with http.get(durl + p, headers={
                    "Range": f"bytes={start}-{end}"}) as r:
                check(r.status == 206 and await r.read()
                      == data[start:end + 1], f"WebDAV Range of {p}: "
                      f"{r.status}")
            return lat

        lat_dav_a = await counted("WebDAV GET intact", dav_get_intact())
        print(f"  WebDAV: PROPFIND Depth 1 of every directory equal to the "
              f"tree, MOVE {moved[0]} -> {moved[1]}, every file and a Range "
              f"GET sha256-equal {tag}")

        # -- 5. ec.encode of each collection through `cli shell -c`
        colls = (GATEWAY_BUCKET, GATEWAY_SIGNED_BUCKET,
                 GATEWAY_DAV_COLLECTION)
        by_coll = {}
        for v in vs.store.volumes.values():
            by_coll.setdefault(v.collection, []).append(v.vid)
        check(sorted(by_coll) == sorted(colls + (GATEWAY_TAMPER_BUCKET,))
              and all(len(x) == 1 for x in by_coll.values()),
              f"volumes by collection {by_coll}: expected one each")
        vids = {c: by_coll[c][0] for c in colls}
        sizes = {GATEWAY_BUCKET: [s3_chunks(s, part) for _, s in files],
                 GATEWAY_SIGNED_BUCKET: [chunk_sizes(s, S3_CHUNK)
                                         for _, s, _ in sobjs],
                 GATEWAY_DAV_COLLECTION: [chunk_sizes(s, dav_chunk)
                                          for _, s in dfiles]}
        bases = {}
        for c in colls:
            base = os.path.join(vs.store.dirs[0], f"{c}_{vids[c]}")
            dat_size = os.path.getsize(base + ".dat")
            reckoned = SUPER_BLOCK_SIZE + sum(
                chunk_record_size(x) for cs in sizes[c] for x in cs)
            check(dat_size == reckoned, f"{c}'s volume {vids[c]} holds "
                  f"{dat_size} bytes; its chunk records sum to {reckoned}")
            step = f"ec.encode {c}"
            out = await counted(step, CliProcess(f"shell-{c}", [
                "shell", "-master", master.url, "-c",
                f"ec.encode -collection {c} -fullPercent 0"], logs).run())
            res = json.loads(out)
            check([r["volume"] for r in res] == [vids[c]]
                  and sorted(res[0]["assignments"].get(vs.url, []))
                  == list(range(gf.TOTAL_SHARDS)),
                  f"{step} answered {res}")
            expected[step] = batched_generate_launches(
                dat_size, vs.store.ec_large_block, vs.store.ec_small_block)
            bases[c] = base
        print(f"  ec.encode -collection (`cli shell -c`, one subprocess "
              f"each): volumes {vids}, .dat sizes as reckoned, "
              f"{ {c: round(timing[f'ec.encode {c}'], 3) for c in colls} } "
              f"s, all 14 shards on the combined server {tag}")

        # -- 6. lose {0,2,4,6} of every EC volume, restart both gateways
        lost = list(FILER_LOST)
        arg = ",".join(map(str, lost))
        for c in colls:
            for path in ("/admin/ec/unmount", "/admin/ec/delete_shards"):
                async with http.post(f"http://{vs.url}{path}", params={
                        "volume": str(vids[c]), "collection": c,
                        "shards": arg}) as r:
                    check(r.status == 200, f"POST {path}: {r.status}")
            check(not any(os.path.exists(bases[c] + pl.to_ext(s))
                          for s in lost), f"lost shards of {c} remain")
        await vs.heartbeat_once()

        async def restart() -> tuple[str, str]:
            for p in (s3alone, davp):
                await p.stop()
            return (await s3alone.start(r"s3 gateway listening on (\S+)"),
                    await davp.start(r"webdav listening on (\S+) "))

        ahost, dav_host = await counted("restarts", restart())
        aurl, durl = f"http://{ahost}", f"http://{dav_host}"

        # the needles each step reads and their recovers from the .ecx
        threshold = vs.store.ec_volumes[vids[GATEWAY_BUCKET]] \
            .small_recover_bytes
        entries = {key: up["filer"].filer.find_entry(
            f"/buckets/{GATEWAY_BUCKET}/{key}") for key, _ in files}
        fids = {key: [ch.file_id for ch in sorted(e.chunks,
                                                  key=lambda ch: ch.offset)]
                for key, e in entries.items()}
        check(all(len(fids[k]) == len(s3_chunks(s, part)) for k, s in files),
              "an object's chunk count differs from its parts")
        big, ivs_all = {}, {}
        for c in colls:
            with open(bases[c] + ".ecx", "rb") as f:
                nids = [key for key, _, _ in walk_index_blob(f.read())]
            ivs = lost_intervals(bases[c], lost, vs.store.ec_large_block,
                                 vs.store.ec_small_block, nids)
            ivs_all[c] = ivs
            big[c] = Counter(iv[0] for iv in ivs if iv[3] >= threshold)

        def drop_caches() -> None:
            for c in colls:
                vs.store.drop_cached_volume(vids[c])
                vs.store.ec_recover_cache.drop_volume(vids[c])

        def nid(fid: str) -> int:
            return st.FileId.parse(fid).key

        # -- 7. degraded reads
        drop_caches()
        check_cache_cold(vs.store, dict.fromkeys(
            nid(f) for fl in fids.values() for f in fl),
            ivs_all[GATEWAY_BUCKET], vids[GATEWAY_BUCKET])
        lat_b = await counted("S3 GET degraded", s3_get_all())
        expected["S3 GET degraded"] = sum(big[GATEWAY_BUCKET].values())

        async def ranges_cold():
            for i, start, end in ranges:
                drop_caches()
                await s3_range(i, start, end)

        await counted("S3 Range degraded", ranges_cold())
        expected["S3 Range degraded"] = sum(
            big[GATEWAY_BUCKET][nid(f)] for i, start, end in ranges
            for f in fids[files[i][0]][start // part:end // part + 1])

        async def signed_get_all() -> list[float]:
            out = []
            for key, _, _ in sobjs:
                path = f"/{GATEWAY_SIGNED_BUCKET}/{key}"
                out.append(await get_object(key, aurl + path,
                                            params=presign_get(ahost, path)))
            return out

        drop_caches()
        lat_s = await counted("signed GET degraded", signed_get_all())
        expected["signed GET degraded"] = sum(
            big[GATEWAY_SIGNED_BUCKET].values())
        drop_caches()
        lat_dav_b = await counted("WebDAV GET degraded", dav_get_all())
        expected["WebDAV GET degraded"] = sum(
            big[GATEWAY_DAV_COLLECTION].values())

        replica = os.path.join(GATEWAY_DIR, "replica")
        drop_caches()
        out = await counted("filer.replicate", CliProcess(
            "filer.replicate", [
                "filer.replicate", "-notify", f"sqlite:{qpath}",
                "-sourceMaster", master.url, "-sourceDir",
                f"/buckets/{GATEWAY_BUCKET}", "-sink", f"local:{replica}",
                "-progress", os.path.join(GATEWAY_DIR, "replicate.progress"),
                "-once"], logs).run())
        expected["filer.replicate"] = sum(big[GATEWAY_BUCKET].values())
        check(re.search(r"replicated \d+ events", out) is not None,
              f"filer.replicate: {out[-500:]}")

        def replica_shas() -> dict:
            got = {}
            for d, _, names in os.walk(replica):
                for n in names:
                    p = os.path.join(d, n)
                    h = hashlib.sha256()
                    with open(p, "rb") as f:
                        for block in iter(lambda: f.read(MIB), b""):
                            h.update(block)
                    got[os.path.relpath(p, replica)] = h.hexdigest()
            return got

        got = await in_thread(replica_shas)
        check(got == {k: shas[k] for k, _ in files},
              f"the replica differs from {GATEWAY_BUCKET}: "
              f"{len(got)} files, {sum(got.get(k) == shas[k] for k, _ in files)}"
              f" equal of {len(files)}")
        for step in GATEWAY_QUIET_STEPS:
            expected[step] = 0
        for c in colls:
            host_n, card_n = split_at(ivs_all[c], threshold)
            print(f"  degraded {c}: shards {lost} lost, {len(ivs_all[c])} "
                  f"intervals on them, {host_n} under the {threshold}-byte "
                  f"threshold (host), {card_n} at or above it (K1) {tag}")
        for name, lat in (("S3 intact", lat_a), ("S3 degraded", lat_b),
                          ("signed presigned degraded", lat_s),
                          ("WebDAV intact", lat_dav_a),
                          ("WebDAV degraded", lat_dav_b)):
            print(f"  GET {name}: {len(lat)} objects in {sum(lat):.3f} s, "
                  f"latency p50 {percentile_ms(lat, 50):.4f} ms, p99 "
                  f"{percentile_ms(lat, 99):.4f} ms {tag}")
        print(f"  filer.replicate -once (a subprocess): {len(got)} objects "
              f"sha256-equal in {timing['filer.replicate']:.3f} s {tag}")
        print(f"  wall seconds per step: "
              f"{ {k: round(v, 4) for k, v in timing.items()} } {tag}")
        print(f"  gateway path kernel launches per step: {launches} {tag}")
        for p in (s3alone, davp):
            await p.stop()
    finally:
        await http.close()
        for p in (s3alone, davp):
            await p.kill()
        queue.close()
        await cli.stop_server(up)
        if rec is not None:
            rec.cancel()
    return {"launches": launches, "expected": expected, "timing": timing,
            "objects": len(files), "lost": lost, "volumes": vids,
            "intervals": {c: len(v) for c, v in ivs_all.items()}}


MOUNT_DIR = os.path.join(ROOT, ".smoke_mount")
# the mount's own collection: ec.encode -collection takes its volume only
MOUNT_COLLECTION = "mount14"
# the mount CLI's -chunkSizeLimitMB default (seaweedfs_tpu/cli.py:563)
MOUNT_CHUNK_MB = 4
# the binding's max_write (fusekernel.MAX_WRITE): the size of each WRITE
# and READ request the phase sends, as a kernel sends them for cp and cat
FUSE_IO = 128 << 10
# the shards lost before the degraded pass, on both servers
MOUNT_LOST = (0, 3, 7, 9)
# the volume servers' -cache.mem: the needle cache gets three quarters
# and keeps needles of up to 1/64 of that (NeedleCache item_max), so 512
# MiB holds a 4 MiB chunk between the 32 READs that each read it whole
# (at the 32 MiB default, every READ of a degraded chunk recovers it)
MOUNT_CACHE_MB = 512


class FuseKernel:
    """The kernel's side of a FUSE session: requests in the FUSE 7.31
    layouts of include/uapi/linux/fuse.h, written to one end of a
    SOCK_SEQPACKET socketpair whose other end a request loop reads as it
    reads /dev/fuse (one request a read, one reply a write). Each call
    waits for its reply and checks its unique id and length; `call`
    returns (error, payload), `raw` the whole reply, the op methods
    raise on an error."""

    IN = struct.Struct("<IIQQIIII")      # len opcode unique nodeid uid gid pid pad
    OUT = struct.Struct("<IiQ")          # len error unique
    ATTR = struct.Struct("<QQQQQQIIIIIIIIII")
    ENTRY = struct.Struct("<QQQQII")     # nodeid generation valid x2, nsec x2
    OPEN = struct.Struct("<QII")         # fh open_flags padding
    RW = struct.Struct("<QQIIQII")       # fuse_read_in / fuse_write_in
    OPS = {"LOOKUP": 1, "GETATTR": 3, "SETATTR": 4, "MKDIR": 9,
           "UNLINK": 10, "RMDIR": 11, "RENAME": 12, "OPEN": 14, "READ": 15,
           "WRITE": 16, "STATFS": 17, "RELEASE": 18, "FSYNC": 20,
           "SETXATTR": 21, "GETXATTR": 22, "LISTXATTR": 23,
           "REMOVEXATTR": 24, "FLUSH": 25, "INIT": 26, "OPENDIR": 27,
           "READDIR": 28, "RELEASEDIR": 29, "ACCESS": 34, "CREATE": 35,
           "DESTROY": 38}
    BIG_WRITES = 1 << 5

    def __init__(self, sock) -> None:
        self.sock = sock
        self.unique = 0

    @staticmethod
    def name(s: str) -> bytes:
        return s.encode() + b"\0"

    def raw(self, op: str | int, nodeid: int = 1, body: bytes = b""
            ) -> bytes:
        """Send one request (an opcode by name, or by number) and return
        its whole reply."""
        self.unique += 1
        self.sock.send(self.IN.pack(self.IN.size + len(body),
                                    self.OPS.get(op, op), self.unique,
                                    nodeid, 0, 0, 0, 0) + body)
        reply = self.sock.recv(FUSE_IO + (1 << 16))
        length, _, unique = self.OUT.unpack_from(reply)
        check(unique == self.unique and length == len(reply),
              f"FUSE {op}: reply {unique} of {length} bytes ({len(reply)} "
              f"read) to request {self.unique}")
        return reply

    def call(self, op: str, nodeid: int = 1, body: bytes = b""
             ) -> tuple[int, bytes]:
        reply = self.raw(op, nodeid, body)
        return self.OUT.unpack_from(reply)[1], reply[self.OUT.size:]

    def ok(self, op: str, nodeid: int = 1, body: bytes = b"") -> bytes:
        error, out = self.call(op, nodeid, body)
        check(error == 0, f"FUSE {op} on node {nodeid}: error {error} "
              f"({os.strerror(-error) if error < 0 else '?'})")
        return out

    def attr(self, raw: bytes, at: int = 0) -> dict:
        f = self.ATTR.unpack_from(raw, at)
        return {"ino": f[0], "size": f[1], "mtime": f[4], "mode": f[9]}

    def init(self) -> tuple:
        out = self.ok("INIT", 0, struct.pack("<IIII", 7, 31, FUSE_IO,
                                             self.BIG_WRITES))
        major, minor, _, flags, _, _, max_write = struct.unpack_from(
            "<IIIIHHI", out)
        return major, minor, flags, max_write

    def lookup(self, parent: int, name: str) -> tuple[int, dict]:
        out = self.ok("LOOKUP", parent, self.name(name))
        return self.ENTRY.unpack_from(out)[0], self.attr(out, self.ENTRY.size)

    def getattr(self, node: int) -> dict:
        out = self.ok("GETATTR", node, struct.pack("<IIQ", 0, 0, 0))
        return self.attr(out, 16)

    def mkdir(self, parent: int, name: str, mode: int = 0o755) -> int:
        out = self.ok("MKDIR", parent,
                      struct.pack("<II", mode, 0o022) + self.name(name))
        return self.ENTRY.unpack_from(out)[0]

    def create(self, parent: int, name: str, mode: int = 0o100644
               ) -> tuple[int, int]:
        out = self.ok("CREATE", parent, struct.pack(
            "<IIII", os.O_WRONLY | os.O_CREAT, mode, 0o022, 0)
            + self.name(name))
        fh = self.OPEN.unpack_from(out, self.ENTRY.size + self.ATTR.size)[0]
        return self.ENTRY.unpack_from(out)[0], fh

    def write(self, node: int, fh: int, offset: int, data: bytes) -> int:
        out = self.ok("WRITE", node, self.RW.pack(
            fh, offset, len(data), 0, 0, os.O_WRONLY, 0) + data)
        return struct.unpack_from("<I", out)[0]

    def open(self, node: int, flags: int = os.O_RDONLY) -> int:
        return self.OPEN.unpack_from(
            self.ok("OPEN", node, struct.pack("<II", flags, 0)))[0]

    def read(self, node: int, fh: int, offset: int, size: int = FUSE_IO,
             op: str = "READ") -> bytes:
        return self.ok(op, node, self.RW.pack(fh, offset, size, 0, 0,
                                              os.O_RDONLY, 0))

    def flush(self, node: int, fh: int) -> None:
        self.ok("FLUSH", node, struct.pack("<QIIQ", fh, 0, 0, 0))

    def release(self, node: int, fh: int, op: str = "RELEASE") -> None:
        self.ok(op, node, struct.pack("<QIIQ", fh, 0, 0, 0))

    def readdir(self, node: int) -> list[str]:
        """OPENDIR, READDIR in 4 KiB pages from each reply's last offset
        until an empty one, RELEASEDIR: the names, "." and ".." left
        out."""
        fh = self.OPEN.unpack_from(self.ok("OPENDIR", node,
                                           struct.pack("<II", 0, 0)))[0]
        names, off = [], 0
        while True:
            out = self.read(node, fh, off, 4096, op="READDIR")
            if not out:
                break
            at = 0
            while at < len(out):
                _, off, n, _ = struct.unpack_from("<QQII", out, at)
                names.append(out[at + 24:at + 24 + n].decode())
                at += (24 + n + 7) // 8 * 8
        self.release(node, fh, op="RELEASEDIR")
        return [n for n in names if n not in (".", "..")]

    def rename(self, parent: int, old: str, new_parent: int,
               new: str) -> None:
        self.ok("RENAME", parent, struct.pack("<Q", new_parent)
                + self.name(old) + self.name(new))

    def unlink(self, parent: int, name: str) -> None:
        self.ok("UNLINK", parent, self.name(name))

    def setxattr(self, node: int, name: str, value: bytes) -> None:
        self.ok("SETXATTR", node, struct.pack("<II", len(value), 0)
                + self.name(name) + value)

    def getxattr(self, node: int, name: str, size: int) -> bytes:
        return self.ok("GETXATTR", node,
                       struct.pack("<II", size, 0) + self.name(name))

    def listxattr(self, node: int) -> list[str]:
        out = self.ok("LISTXATTR", node, struct.pack("<II", 1 << 16, 0))
        return [n.decode() for n in out.split(b"\0") if n]

    def destroy(self) -> None:
        self.ok("DESTROY", 1)


def fuse_socketpair() -> tuple:
    """(the kernel's end, the device's fd): a SOCK_SEQPACKET pair keeps
    /dev/fuse's one message a read; the buffers take a WRITE request of
    FUSE_IO bytes with its headers."""
    import socket
    kernel, device = socket.socketpair(socket.AF_UNIX, socket.SOCK_SEQPACKET)
    for s in (kernel, device):
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            s.setsockopt(socket.SOL_SOCKET, opt, 4 * MIB)
    return kernel, device.detach()


def serve_fuse(fusekernel, ops, mountpoint: str):
    """Start fusekernel.FUSE(ops, mountpoint) on a thread of its own with
    its _mount_dev_fuse replaced, for this call only, by one that hands
    it the device end of fuse_socketpair(); returns (the kernel's side,
    the thread). The loop serves until a DESTROY, then calls
    ops.destroy."""
    import threading
    kernel_sock, device_fd = fuse_socketpair()
    ready = threading.Event()
    real = fusekernel._mount_dev_fuse
    fusekernel._mount_dev_fuse = lambda mp, allow_other: device_fd
    try:
        t = threading.Thread(target=fusekernel.FUSE, args=(ops, mountpoint),
                             kwargs={"ready_event": ready}, daemon=True)
        t.start()
        check(ready.wait(30), "the FUSE request loop did not start")
    finally:
        fusekernel._mount_dev_fuse = real
    return FuseKernel(kernel_sock), t


def mount_bytes(seed: int, i: int, size: int) -> bytes:
    """The contents of file i of phase 14's tree."""
    return np.random.default_rng([seed, 14, i]).bytes(size)


def mount_plan(seed: int, target: int) -> dict:
    """Phase 14's tree and its changes, from the seed alone: phase 12's
    tree (filer_tree) of `target` bytes, two of its small files (one
    renamed into another directory, one unlinked), and the large file
    whose chunks the cold READs start."""
    dirs, files = filer_tree(seed, target)
    rng = np.random.default_rng([seed, 14])
    small = [i for i, (_, size) in enumerate(files)
             if size <= FILER_SMALL[1]]
    moved, gone = (int(i) for i in rng.choice(small, 2, replace=False))
    src = posixpath.dirname(files[moved][0])
    dest = next(d for d in dirs if d != src)
    renamed = f"{dest}/renamed-{posixpath.basename(files[moved][0])}"
    largest = max(range(len(files)), key=lambda i: files[i][1])
    return {"dirs": dirs, "files": files, "moved": moved,
            "renamed": renamed, "gone": gone, "largest": largest}


def mount_layout(seed: int, target: int, chunk: int = MOUNT_CHUNK_MB * MIB
                 ) -> list[tuple]:
    """The collection volume's records in .dat order, from the seed
    alone: (file index, chunk index, offset, record bytes) of each
    chunk, the files written one after another in chunk-size pieces
    (aligned 128 KiB WRITEs fill the dirty-page buffer to the chunk
    limit), then (file index, -1, offset, 32) for the tombstone each
    chunk of the unlinked file gets."""
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    plan = mount_plan(seed, target)
    out, pos = [], SUPER_BLOCK_SIZE
    for i, (_, size) in enumerate(plan["files"]):
        for j, c in enumerate(chunk_sizes(size, chunk)):
            out.append((i, j, pos, chunk_record_size(c)))
            pos += chunk_record_size(c)
    tomb = st.actual_size(0, st.CURRENT_VERSION)
    for _ in chunk_sizes(plan["files"][plan["gone"]][1], chunk):
        out.append((plan["gone"], -1, pos, tomb))
        pos += tomb
    return out


def walk_dat(path: str) -> list[tuple]:
    """(offset, needle id, record bytes) of every record of a .dat,
    walked from the super block by each header's size field."""
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE
    out = []
    with open(path, "rb") as f:
        pos, end = SUPER_BLOCK_SIZE, os.path.getsize(path)
        while pos < end:
            f.seek(pos)
            head = f.read(st.NEEDLE_HEADER_SIZE)
            nid = int.from_bytes(head[4:12], "big")
            size = int.from_bytes(head[12:16], "big")
            record = st.actual_size(size, st.CURRENT_VERSION)
            out.append((pos, nid, record))
            pos += record
    return out


def mount_prediction(seed: int, target: int,
                     chunk: int = MOUNT_CHUNK_MB * MIB,
                     lost: tuple = MOUNT_LOST) -> dict:
    """Phase 14's K1 launches per step, reckoned on any host from the
    seed alone. The files go in one at a time, so every chunk's offset
    in the collection's one volume is known (mount_layout), and so are
    the whole 1 MiB blocks on lost shards that each chunk record covers
    (full_blocks_lost): the degraded pass recovers each once, since the
    needle cache holds a chunk between the READs of it; each cold READ,
    with the caches emptied first, recovers its chunk's whole. The
    ec.encode count is the .dat's row batches."""
    plan = mount_plan(seed, target)
    layout = mount_layout(seed, target, chunk)
    dat_size = layout[-1][2] + layout[-1][3]
    lost_of = {(i, j): full_blocks_lost(off, rec, lost)
               for i, j, off, rec in layout if j >= 0}
    read = [i for i in range(len(plan["files"])) if i != plan["gone"]]
    largest = plan["largest"]
    n_large = len(chunk_sizes(plan["files"][largest][1], chunk))
    return {"INIT": 0, "write": 0, "listing": 0, "READ intact": 0,
            "rename, unlink, xattr": 0,
            "ec.encode": batched_generate_launches(
                dat_size, pl.LARGE_BLOCK_SIZE, pl.SMALL_BLOCK_SIZE),
            "READ degraded": sum(n for (i, _), n in lost_of.items()
                                 if i in read),
            "READ cold": sum(lost_of[(largest, j)] for j in range(n_large)),
            "DESTROY": 0}


def phase_mount(dev: torch.device, seed: int, target: int, *,
                card: str = "", backend: str = "gpu",
                chunk_mb: int = MOUNT_CHUNK_MB) -> dict:
    """The FUSE mount over the port's own cluster, no module of
    seaweedfs_tpu in this process: a port master (cli.start_master, its
    volume limit twice the tree) and two port volume servers
    (cli.start_volume, -ecBackend <backend>, -cache.mem MOUNT_CACHE_MB)
    in process, and a WFS over Filer("memory") with a collection of its
    own and MountOptions(chunk_size_limit=chunk_mb MiB), as `cli mount`
    builds it, wrapped in the port's SeaweedFuseOps and served by the
    port's fusekernel.FUSE request loop over a SOCK_SEQPACKET socketpair
    (serve_fuse), whose other end this phase drives as the kernel:
    INIT; MKDIR and CREATE/WRITE/FLUSH/RELEASE of a tree made from
    `seed` up to `target` bytes, in 128 KiB WRITEs, one file after
    another; READDIR, LOOKUP and GETATTR over the tree; OPEN/READ/RELEASE
    of every file (sha256); a RENAME, an UNLINK and SETXATTR/GETXATTR;
    ec.encode -collection; shards {0,3,7,9} lost and the caches emptied;
    every file again through READs; one READ at the start of each chunk
    of the largest file with the caches emptied before each; DESTROY.
    Returns the launch counts, what the .ecx says they must be and the
    timings."""
    import asyncio
    run_dir = os.path.join(MOUNT_DIR, "run")
    shutil.rmtree(MOUNT_DIR, ignore_errors=True)
    for d in ("m", "v0", "v1"):
        os.makedirs(os.path.join(run_dir, d))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return asyncio.run(_drive_mount(dev, seed, target, run_dir, card,
                                        backend, chunk_mb * MIB))
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(MOUNT_DIR, ignore_errors=True)


async def _drive_mount(dev: torch.device, seed: int, target: int,
                       run_dir: str, card: str, backend: str,
                       chunk: int) -> dict:
    import asyncio
    import contextlib
    import errno
    import aiohttp
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.filer.filer import Filer
    from seaweedfs_tpu_torch.mount import fuse_adapter, fusekernel
    from seaweedfs_tpu_torch.mount.wfs import WFS, MountOptions
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.shell.runner import dispatch

    tag = f"[{card}]" if card else ""
    launches, expected, timing = {}, {}, {}
    plan = mount_plan(seed, target)
    dirs, files = plan["dirs"], plan["files"]
    paths = [rel for rel, _ in files]
    total = sum(size for _, size in files)
    shas = [hashlib.sha256(mount_bytes(seed, i, size)).hexdigest()
            for i, (_, size) in enumerate(files)]
    parser = cli.build_parser()
    check(fuse_adapter.KERNEL_BINDING == "builtin",
          f"the adapter took the {fuse_adapter.KERNEL_BINDING} binding")

    async def counted(step: str, work):
        """Await a coroutine, or run a function on a thread of its own
        (the FUSE loop's replies need this loop to serve the servers'
        HTTP), counting K1's launches."""
        gf256_cuda.launches = 0
        t0 = time.perf_counter()
        out = await (work if asyncio.iscoroutine(work)
                     else asyncio.to_thread(work))
        sync(dev)
        timing[step] = time.perf_counter() - t0
        launches[step] = gf256_cuda.launches
        return out

    limit_mb = 2 * -(-target // MIB)
    master, mrec = await cli.start_master(parser.parse_args(
        cluster_master_args(run_dir, limit_mb)))
    servers, recs = [], [mrec]
    http = aiohttp.ClientSession(timeout=aiohttp.ClientTimeout(total=600))
    fuse_thread, kernel = None, None
    try:
        for i in range(2):
            vs, rec = await cli.start_volume(parser.parse_args(
                server_args(backend, os.path.join(run_dir, f"v{i}"),
                            master=master.url, cache_mb=MOUNT_CACHE_MB)
                + ["-max", str(CLUSTER_MAX_VOLUMES)]))
            servers.append(vs)
            recs.append(rec)
            check(await vs.heartbeat_once(),
                  f"volume server {vs.url} not registered with the master")
        wfs = WFS(Filer("memory"), master.url,
                  MountOptions(collection=MOUNT_COLLECTION,
                               chunk_size_limit=chunk))
        ops = await asyncio.to_thread(fuse_adapter.SeaweedFuseOps, wfs)
        kernel, fuse_thread = await asyncio.to_thread(
            serve_fuse, fusekernel, ops, os.path.join(run_dir, "mnt"))
        node = {"": 1}

        # -- 1. INIT
        major, minor, flags, max_write = await counted("INIT", kernel.init)
        check((major, minor, max_write) == (7, 31, FUSE_IO)
              and flags & FuseKernel.BIG_WRITES,
              f"INIT answered {major}.{minor}, flags {flags:#x}, max_write "
              f"{max_write}")
        print(f"  INIT: protocol {major}.{minor}, max_write {max_write}, "
              f"the {fuse_adapter.KERNEL_BINDING} binding "
              f"(fusekernel.FUSE) over a SOCK_SEQPACKET socketpair {tag}")

        # -- 2. the tree, one file after another
        def write_tree() -> None:
            for d in dirs:
                parent, _, name = d.rpartition("/")
                node[d] = kernel.mkdir(node[parent], name)
            for i, (rel, size) in enumerate(files):
                parent, _, name = rel.rpartition("/")
                nid, fh = kernel.create(node[parent], name)
                node[rel] = nid
                data = mount_bytes(seed, i, size)
                for off in range(0, size, FUSE_IO):
                    piece = data[off:off + FUSE_IO]
                    check(kernel.write(nid, fh, off, piece) == len(piece),
                          f"WRITE {rel} at {off}: short")
                kernel.flush(nid, fh)
                kernel.release(nid, fh)

        n_writes = sum(-(-size // FUSE_IO) for _, size in files)
        await counted("write", write_tree)
        # each file's chunk fids, in offset order, before any change
        fids = [[c.file_id for c in sorted(
            wfs.filer.find_entry("/" + rel).chunks, key=lambda c: c.offset)]
            for rel in paths]
        check(all(len(fl) == len(chunk_sizes(size, chunk))
                  for fl, (_, size) in zip(fids, files)),
              "a file's chunk count differs from its size over the chunk "
              "limit")
        t = timing["write"]
        print(f"  write: {len(files)} files in {len(dirs)} directories, "
              f"{total} bytes in {n_writes} WRITEs of up to 128 KiB, one "
              f"file after another, {t:.3f} s ({total / t / 1e6:.1f} MB/s "
              f"through the mount) {tag}")

        # -- 3. READDIR, LOOKUP and GETATTR over the tree
        def list_tree() -> None:
            for d in [""] + dirs:
                want = sorted([posixpath.basename(x) for x in dirs
                               if posixpath.dirname(x) == d]
                              + [posixpath.basename(r) for r in paths
                                 if posixpath.dirname(r) == d])
                got = kernel.readdir(node[d])
                check(sorted(got) == want, f"READDIR {d or '/'}: "
                      f"{sorted(set(got) ^ set(want))[:4]} differ")
            for rel, size in files:
                parent, _, name = rel.rpartition("/")
                nid, a = kernel.lookup(node[parent], name)
                b = kernel.getattr(nid)
                check(nid == node[rel] and a["size"] == b["size"] == size
                      and b["mode"] & 0o170000 == 0o100000,
                      f"{rel}: LOOKUP node {nid} size {a['size']}, GETATTR "
                      f"size {b['size']} mode {b['mode']:o}; wrote {size}")

        await counted("listing", list_tree)
        print(f"  listing: READDIR of {len(dirs) + 1} directories equal to "
              f"the tree, LOOKUP and GETATTR of {len(files)} files equal to "
              f"their sizes, {timing['listing']:.3f} s {tag}")

        def read_file(rel: str, i: int, lat: list) -> None:
            nid = node[rel]
            fh = kernel.open(nid)
            h, off = hashlib.sha256(), 0
            while True:
                t0 = time.perf_counter()
                out = kernel.read(nid, fh, off)
                lat.append(time.perf_counter() - t0)
                h.update(out)
                off += len(out)
                if len(out) < FUSE_IO:
                    break
            kernel.release(nid, fh)
            check(off == files[i][1] and h.hexdigest() == shas[i],
                  f"READ {rel}: {off} bytes, sha256 "
                  f"{'equal' if h.hexdigest() == shas[i] else 'differs'}")

        # -- 4. every file through OPEN/READ/RELEASE, intact
        lat_a: list[float] = []
        await counted("READ intact", lambda: [
            read_file(rel, i, lat_a) for i, rel in enumerate(paths)])

        # -- 5. a RENAME, an UNLINK and the xattrs
        moved, gone, largest = plan["moved"], plan["gone"], plan["largest"]

        def change_tree() -> None:
            rel, new = paths[moved], plan["renamed"]
            op_, _, on = rel.rpartition("/")
            np_, _, nn = new.rpartition("/")
            kernel.rename(node[op_], on, node[np_], nn)
            err, _ = kernel.call("LOOKUP", node[op_], kernel.name(on))
            check(err == -errno.ENOENT, f"LOOKUP {rel} after RENAME: {err}")
            nid, a = kernel.lookup(node[np_], nn)
            check(nid == node[rel] and a["size"] == files[moved][1],
                  f"LOOKUP {new}: node {nid}, size {a['size']}")
            node[new] = node.pop(rel)
            paths[moved] = new
            rel = paths[gone]
            gp, _, gn = rel.rpartition("/")
            kernel.unlink(node[gp], gn)
            err, _ = kernel.call("LOOKUP", node[gp], kernel.name(gn))
            check(err == -errno.ENOENT and gn not in kernel.readdir(node[gp]),
                  f"{rel} still there after UNLINK: LOOKUP {err}")
            target_node, value = node[paths[largest]], f"seed {seed}".encode()
            kernel.setxattr(target_node, "user.seed", value)
            size = struct.unpack_from(
                "<I", kernel.getxattr(target_node, "user.seed", 0))[0]
            got = kernel.getxattr(target_node, "user.seed", size)
            check(size == len(value) and got == value
                  and kernel.listxattr(target_node) == ["user.seed"],
                  f"GETXATTR user.seed: size {size}, value {got!r}")
            ops.lt.run(wfs.drain_deletes())

        await counted("rename, unlink, xattr", change_tree)
        print(f"  RENAME {files[moved][0]} -> {plan['renamed']}, UNLINK "
              f"{files[gone][0]} (its chunks deleted), SETXATTR/GETXATTR "
              f"user.seed on {paths[largest]}: each checked, "
              f"{timing['rename, unlink, xattr']:.3f} s {tag}")

        # -- 6. ec.encode -collection through the port's shell
        vids = {int(fid.split(",")[0]) for fl in fids for fid in fl}
        check(len(vids) == 1, f"the chunks landed in volumes {vids}, "
              f"expected one")
        vid = next(iter(vids))
        for vs in servers:
            await vs.heartbeat_once()
        source = next(vs for vs in servers if vid in vs.store.volumes)
        dat = os.path.join(source.store.dirs[0],
                           f"{MOUNT_COLLECTION}_{vid}.dat")
        layout = mount_layout(seed, target, chunk)
        dat_size = layout[-1][2] + layout[-1][3]
        deadline = time.monotonic() + 30
        while (os.path.getsize(dat) < dat_size
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)     # the deletes' tombstones
        walk = walk_dat(dat)
        key = [st.FileId.parse(fid).key for fl in fids for fid in fl]
        check([(off, rec) for off, _, rec in walk]
              == [(off, rec) for _, _, off, rec in layout]
              and [nid for _, nid, _ in walk[:len(key)]] == key
              and sorted(nid for _, nid, _ in walk[len(key):])
              == sorted(st.FileId.parse(f).key for f in fids[gone]),
              f"volume {vid}'s .dat holds {len(walk)} records over "
              f"{os.path.getsize(dat)} bytes; the seed puts {len(layout)} "
              f"over {dat_size}, the chunks in the order written, then "
              f"the unlinked file's tombstones")
        nid_of = {fid: st.FileId.parse(fid).key
                  for i, fl in enumerate(fids) if i != gone for fid in fl}

        async def shell(command: str):
            async with CommandEnv(master.url, http) as env:
                return await dispatch(env, command)

        res = await counted("ec.encode", shell(
            f"ec.encode -collection {MOUNT_COLLECTION} -fullPercent 0"))
        check(isinstance(res, list) and [r["volume"] for r in res]
              == [vid], f"ec.encode answered {res}, expected volume {vid}")
        spread = {u: sorted(s) for u, s in res[0]["assignments"].items()}
        expected["ec.encode"] = batched_generate_launches(
            dat_size, source.store.ec_large_block,
            source.store.ec_small_block)
        print(f"  ec.encode -collection {MOUNT_COLLECTION} (the port's "
              f"shell): volume {vid}, the one the master grew for the "
              f"collection, .dat {dat_size} bytes (each record where the "
              f"seed puts it), {timing['ec.encode']:.3f} s, shards "
              f"{spread} {tag}")

        # -- 7. shards {0,3,7,9} lost, the servers' caches emptied
        for vs in servers:
            await vs.heartbeat_once()
        lost = list(MOUNT_LOST)
        for url, held in spread.items():
            mine = [s for s in held if s in lost]
            if not mine:
                continue
            for path in ("/admin/ec/unmount", "/admin/ec/delete_shards"):
                async with http.post(f"http://{url}{path}", params={
                        "volume": str(vid), "collection": MOUNT_COLLECTION,
                        "shards": ",".join(map(str, mine))}) as r:
                    check(r.status == 200, f"POST {path} on {url}: "
                          f"{r.status} {await r.text()}")
        for vs in servers:
            ev = vs.store.ec_volumes.get(vid)
            check(ev is not None and not set(ev.shards) & set(lost),
                  f"{vs.url} still holds lost shards of volume {vid}")
            vs.store.drop_cached_volume(vid)
            vs.store.ec_recover_cache.drop_volume(vid)
            await vs.heartbeat_once()
        present = next(s for s in range(gf.TOTAL_SHARDS) if s not in lost)
        holder = next(vs for vs in servers
                      if present in vs.store.ec_volumes[vid].shards)
        hbase = os.path.join(holder.store.dirs[0], f"{MOUNT_COLLECTION}_{vid}")
        ivs = lost_intervals(hbase, lost, holder.store.ec_large_block,
                             holder.store.ec_small_block,
                             list(nid_of.values()))
        for vs in servers:
            check_cache_cold(vs.store, dict.fromkeys(nid_of.values()),
                             ivs, vid)
        threshold = holder.store.ec_volumes[vid].small_recover_bytes
        big = Counter(iv[0] for iv in ivs if iv[3] >= threshold)

        # -- 8. every file again through READs, degraded
        lat_b: list[float] = []
        await counted("READ degraded", lambda: [
            read_file(rel, i, lat_b) for i, rel in enumerate(paths)
            if i != gone])
        expected["READ degraded"] = sum(big.values())
        host_n, card_n = split_at(ivs, threshold)

        # -- 9. one READ at the start of each chunk of the largest file,
        # the servers' caches emptied before each
        lat_c: list[float] = []
        large = paths[largest]
        starts = list(range(0, files[largest][1], chunk))
        want = mount_bytes(seed, largest, files[largest][1])

        def read_cold() -> None:
            nid = node[large]
            fh = kernel.open(nid)
            for off in starts:
                for vs in servers:
                    vs.store.drop_cached_volume(vid)
                    vs.store.ec_recover_cache.drop_volume(vid)
                t0 = time.perf_counter()
                out = kernel.read(nid, fh, off)
                lat_c.append(time.perf_counter() - t0)
                check(out == want[off:off + FUSE_IO],
                      f"cold READ of {large} at {off} differs")
            kernel.release(nid, fh)

        await counted("READ cold", read_cold)
        expected["READ cold"] = sum(big[nid_of[fid]]
                                    for fid in fids[largest])
        print(f"  degraded: shards {lost} lost, {len(ivs)} intervals on "
              f"them: {host_n} under the {threshold}-byte threshold (host), "
              f"{card_n} at or above it (K1); every file sha256-equal "
              f"through READs; -cache.mem {MOUNT_CACHE_MB} {tag}")
        for name, lat in (("intact", lat_a), ("degraded", lat_b),
                          ("cold (caches emptied before each)", lat_c)):
            print(f"  READ {name}: {len(lat)} requests of up to 128 KiB in "
                  f"{sum(lat):.3f} s, latency p50 "
                  f"{percentile_ms(lat, 50):.4f} ms, p99 "
                  f"{percentile_ms(lat, 99):.4f} ms {tag}")

        # -- 10. DESTROY: the loop answers, ends and closes the WFS
        await counted("DESTROY", kernel.destroy)
        await asyncio.to_thread(fuse_thread.join, 30)
        check(not fuse_thread.is_alive(),
              "the FUSE loop did not end after DESTROY")
        check(not ops.lt.thread.is_alive(),
              "SeaweedFuseOps' loop thread runs on after DESTROY")
        for step in ("INIT", "write", "listing", "READ intact",
                     "rename, unlink, xattr", "DESTROY"):
            expected[step] = 0
        print(f"  wall seconds per step: "
              f"{ {k: round(v, 4) for k, v in timing.items()} } {tag}")
        print(f"  mount path kernel launches per step: {launches} {tag}")
    finally:
        if fuse_thread is not None and fuse_thread.is_alive():
            # a check failed between requests: end the session as the
            # kernel would, so the loop closes the WFS and stops
            with contextlib.suppress(Exception):
                await asyncio.to_thread(kernel.call, "DESTROY")
            await asyncio.to_thread(fuse_thread.join, 30)
        if kernel is not None:
            kernel.sock.close()
        await http.close()
        for vs in servers:
            await vs.stop()
        await master.stop()
        for rec in recs:
            if rec is not None:
                rec.cancel()
    return {"launches": launches, "expected": expected, "timing": timing,
            "files": len(files), "intervals": len(ivs),
            "split": (host_n, card_n), "lost": lost, "volume": vid,
            "dat_size": dat_size, "walk": walk,
            "read_s": {"intact": lat_a, "degraded": lat_b, "cold": lat_c}}


SOAK_DIR = os.path.join(ROOT, ".smoke_soak")
# the rebuild soak's verify passes, in the order the scenario runs them
SOAK_PASSES = ("after encode", "degraded (server killed)",
               "after ec.rebuild")
SOAK_FILES = 900          # the scenario's fill (tools/soak.py, rebuild)
SOAK_DAEMONS = 5          # its master and 4 volume servers


def shell_result(out: str):
    """The JSON value that `cli shell -c` prints, from the captured
    stdout + stderr of the run (log and import-trace lines around it), or
    None where it printed none."""
    dec = json.JSONDecoder()
    pos = 0
    for line in out.splitlines(keepends=True):
        if line[:1] in "[{":
            try:
                return dec.raw_decode(out, pos)[0]
            except ValueError:
                pass
        pos += len(line)
    return None


def volume_holders(master: str) -> dict[str, set[int]]:
    """url -> the ids of the normal volumes the master lists on it."""
    import urllib.request
    with urllib.request.urlopen(f"http://{master}/vol/volumes",
                                timeout=30) as r:
        body = json.load(r)
    return {n["url"]: {m["id"] for m in n["volumes"]} for n in body["nodes"]}


def phase_soak(card: str = "", on_card: bool = True,
               base_port: int | None = None) -> dict:
    """The port's `rebuild` soak (seaweedfs_tpu_torch/tools/soak.py,
    scenario_rebuild) as `soak rebuild` runs it: a master and 4 volume
    servers as `python -m seaweedfs_tpu_torch.cli` subprocesses, 900
    files at replication 000, `ec.encode -fullPercent 1` through the
    shell subprocess, a SIGKILLed shard holder, `ec.rebuild -force`, and
    a verify of every file after each step. soak.py is wrapped from
    outside for the call: its Procs class (the daemons' and the shell's
    environment gets PYTHONPROFILEIMPORTTIME=1; on the card it drops
    SWTPU_TORCH_EC_BACKEND, so each volume server runs its default
    `auto`, the GPU) and its verify (timed). Holds: zero bad reads in
    each pass; on the card, right after ec.encode every live volume
    server that received /admin/ec/generate, and right after ec.rebuild
    the rebuilding server, holds a CUDA context (K1 ran there; their
    launches are not counted, they are other processes); no daemon and
    no shell run imported jax or seaweedfs_tpu. `base_port` moves the
    scenario's ports (soak.BASE_PORT) for the call."""
    import asyncio
    from seaweedfs_tpu_torch.tools import soak

    shutil.rmtree(SOAK_DIR, ignore_errors=True)
    os.makedirs(SOAK_DIR)
    tag = f"({card})" if card else "(CPU rehearsal)"
    seen: dict = {"verify": [], "shell": [], "encode": {}, "rebuild": {}}

    class WatchedProcs(soak.Procs):
        def __init__(self, tmp: str):
            super().__init__(tmp)
            self.env["PYTHONPROFILEIMPORTTIME"] = "1"
            self.env.pop(pl.METHOD_ENV, None)
            if on_card:
                self.env.pop(pl.BACKEND_ENV, None)

        def server(self, url: str) -> dict:
            port = url.rsplit(":", 1)[1]
            for p in self.procs:
                if p.args[3] == "volume" and \
                        p.args[p.args.index("-port") + 1] == port:
                    return {"pid": p.pid, "alive": p.poll() is None,
                            "context": holds_cuda_context(p.pid)
                            if on_card and p.poll() is None else None}
            return {"pid": None, "alive": False, "context": None}

        def shell(self, master: str, cmd: str) -> str:
            verb = cmd.split()[0]
            before = volume_holders(master) if verb == "ec.encode" else {}
            t0 = time.perf_counter()
            out = super().shell(master, cmd)
            res = shell_result(out)
            seen["shell"].append({
                "cmd": cmd, "s": time.perf_counter() - t0,
                "traced": "import time:" in out,
                "forbidden": forbidden_imports(out), "result": res})
            if verb == "ec.encode":
                vids = {r["volume"] for r in res or ()}
                seen["encode"] = {url: self.server(url)
                                  for url, held in before.items()
                                  if held & vids}
            elif verb == "ec.rebuild":
                seen["rebuild"] = {r["node"]: self.server(r["node"])
                                   for r in res or () if "node" in r}
            return out

    plain_verify = soak.verify

    async def timed_verify(client, payloads: dict, what: str) -> int:
        t0 = time.perf_counter()
        bad = await plain_verify(client, payloads, what)
        seen["verify"].append({"pass": what, "bad": bad,
                               "files": len(payloads),
                               "s": time.perf_counter() - t0})
        return bad

    saved = (soak.Procs, soak.verify, soak.BASE_PORT)
    soak.Procs, soak.verify = WatchedProcs, timed_verify
    if base_port is not None:
        soak.BASE_PORT = base_port
    t0 = time.perf_counter()
    try:
        bad = asyncio.run(soak.scenario_rebuild(SOAK_DIR))
        wall = time.perf_counter() - t0
        logs = {}
        for name in sorted(os.listdir(SOAK_DIR)):
            if name.endswith(".log"):
                with open(os.path.join(SOAK_DIR, name)) as f:
                    logs[name] = f.read()
        for v in seen["verify"]:
            print(f"  verify {v['pass']}: bad={v['bad']}/{v['files']} in "
                  f"{v['s']:.3f} s {tag}")
        for s in seen["shell"]:
            print(f"  shell {s['cmd']!r}: {s['s']:.3f} s {tag}")
        print(f"  volume servers that received /admin/ec/generate, right "
              f"after ec.encode: {seen['encode']}")
        print(f"  the rebuilding server, right after ec.rebuild: "
              f"{seen['rebuild']}")
        check(bad == 0, f"the rebuild soak counted {bad} bad reads")
        check([(v["pass"], v["bad"], v["files"]) for v in seen["verify"]]
              == [(p, 0, SOAK_FILES) for p in SOAK_PASSES],
              f"verify passes {seen['verify']}, expected "
              f"{SOAK_PASSES} each with 0 bad of {SOAK_FILES}")
        check([s["cmd"].split()[0] for s in seen["shell"]]
              == ["ec.encode", "ec.rebuild"]
              and all(s["result"] for s in seen["shell"]),
              f"shell runs {seen['shell']}")
        check(seen["encode"] and all(s["alive"]
                                     for s in seen["encode"].values()),
              f"no live volume server received /admin/ec/generate: "
              f"{seen['encode']}")
        check(seen["rebuild"] and all(s["alive"]
                                      for s in seen["rebuild"].values()),
              f"no live server rebuilt: {seen['rebuild']}")
        if on_card:
            for step in ("encode", "rebuild"):
                check(all(s["context"] for s in seen[step].values()),
                      f"a server of ec.{step} holds no CUDA context: "
                      f"{seen[step]}")
        check(len(logs) == SOAK_DAEMONS,
              f"{len(logs)} daemon logs, expected {SOAK_DAEMONS}")
        untraced = [name for name, text in logs.items()
                    if "import time:" not in text]
        untraced += [s["cmd"] for s in seen["shell"] if not s["traced"]]
        check(not untraced, f"no import trace in {untraced}")
        bad_imports = {name: forbidden_imports(text)
                       for name, text in logs.items()}
        bad_imports.update({s["cmd"]: s["forbidden"]
                            for s in seen["shell"]})
        check(not any(bad_imports.values()),
              f"spawned processes imported {bad_imports}")
        threads, children = left_running()
        check(children == [], f"child processes left running: {children}")
        print(f"  no daemon or shell imported jax or seaweedfs_tpu "
              f"({len(logs)} daemon logs, {len(seen['shell'])} shell runs "
              f"with PYTHONPROFILEIMPORTTIME=1); no child left running")
        print(f"  the degraded pass reads needles of 500-30,000 B: every "
              f"recover is under the 1 MiB -ec.smallrecover and runs on the "
              f"host, not on the card")
        print(f"  phase 15 wall: {wall:.3f} s {tag}")
    except BaseException:
        for name in sorted(os.listdir(SOAK_DIR)):
            if name.endswith(".log"):
                with open(os.path.join(SOAK_DIR, name)) as f:
                    lines = [ln for ln in f.read().splitlines()
                             if not ln.startswith("import time:")]
                print(f"  {name} (tail, import trace left out):\n"
                      + "\n".join(lines[-30:]))
        raise
    finally:
        soak.Procs, soak.verify, soak.BASE_PORT = saved
    shutil.rmtree(SOAK_DIR, ignore_errors=True)
    seen.update(bad=bad, wall=wall)
    return seen


def driver_runs() -> list[tuple[str, list[str]]]:
    """Every scenario of the port's drivers once: each soak scenario (at
    --quick, which only heal, qos and meta read), chaos and chaos ha at
    --quick, and the three wire smokes, as (driver, arguments)."""
    from seaweedfs_tpu_torch.tools import soak
    return ([("soak", [name, "--quick"]) for name in soak.SCENARIOS]
            + [("chaos", ["--quick"]), ("chaos", ["ha", "--quick"])]
            + [(name, []) for name in ("wire_smoke", "recorder_smoke",
                                       "fabric_smoke")])


# the longest one driver run may take (slo's armed phase alone is 300 s)
DRIVER_TIMEOUT_S = 900


def run_drivers(out_dir: str, card: str = "",
                runs: list | None = None) -> list[dict]:
    """Run each of `runs` (default driver_runs()) as `python -m
    seaweedfs_tpu_torch.tools.<driver> <arguments>` in a subprocess of
    this environment, one after another: nothing is forced, so on the
    card every volume server runs its default -ecBackend auto, the GPU.
    Prints one row per run (pass or fail by its exit code, and its wall
    seconds) beside the card, writes each run's output to out_dir, and
    returns the rows."""
    os.makedirs(out_dir, exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", pl.METHOD_ENV)}
    rows = []
    for driver, argv in runs or driver_runs():
        name = " ".join([driver] + argv)
        log = os.path.join(out_dir, name.replace(" ", "_") + ".log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            try:
                rc = subprocess.run(
                    [sys.executable, "-m",
                     f"seaweedfs_tpu_torch.tools.{driver}", *argv],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                    timeout=DRIVER_TIMEOUT_S).returncode
            except subprocess.TimeoutExpired:
                rc = None
        wall = time.perf_counter() - t0
        with open(log) as f:
            tail = [ln for ln in f.read().splitlines()
                    if ln.strip() and not ln.startswith((" ", "Traceback"))]
        rows.append({"run": name, "rc": rc, "s": wall,
                     "last": tail[-1][:160] if tail else ""})
        print(f"  {name}: {'pass' if rc == 0 else 'FAIL'} (exit {rc}) in "
              f"{wall:.3f} s; last line {rows[-1]['last']!r} "
              f"({card or 'no card named'})", flush=True)
    return rows


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--volume-mib", type=int, default=1024,
                   help="size of the generated .dat (default 1 GiB)")
    p.add_argument("--flagship-mib", type=int, default=256,
                   help="bytes per shard of the flagship steps")
    p.add_argument("--mesh-volumes", type=int, default=3,
                   help="volumes of the mesh path's batch")
    p.add_argument("--mesh-mib", type=int, default=256,
                   help="bytes per shard of the mesh path")
    p.add_argument("--store-mib", type=int, default=1024,
                   help="size the store phase fills its volume's .dat to")
    p.add_argument("--server-mib", type=int, default=512,
                   help="size the server phase fills its volume's .dat to "
                        "(phases 8, 9 and 11 use that volume, and phase "
                        "12's tree is about this size; 1024 before phase "
                        "15 joined the script)")
    p.add_argument("--mxu-extra-mib", type=int, default=64,
                   help="size of the second volume phase 9 writes")
    p.add_argument("--workers-mib", type=int, default=256,
                   help="size of each volume of phase 10's -workers 2")
    p.add_argument("--gateway-mib", type=int, default=256,
                   help="size of phase 13's object tree (phase 12's tree "
                        "at this size; 512 before phase 15 joined the "
                        "script)")
    p.add_argument("--mount-mib", type=int, default=256,
                   help="size of the tree phase 14 writes through the "
                        "FUSE mount (phase 12's tree at this size)")
    p.add_argument("--parent-k5", default=None,
                   help="a directory holding an earlier commit's "
                        "ops/crc32c_cuda.py and ops/csrc/crc32c.cu, timed "
                        "in turns with K5 in phase 5 (default: commit "
                        f"{K5_PARENT}'s, where git can show them)")
    return p.parse_args(argv)


class PhaseClock:
    """Prints each phase's header, and before it the wall seconds of the
    phase before (phase(None) closes the last one)."""

    def __init__(self):
        self.name, self.t0 = None, time.perf_counter()

    def phase(self, header: str | None) -> None:
        now = time.perf_counter()
        if self.name is not None:
            print(f"  {self.name} took {now - self.t0:.1f} s", flush=True)
        if header is not None:
            print(header, flush=True)
            self.name = header[3:].split(":")[0]
        self.t0 = now


def left_running() -> tuple[list[str], list[str]]:
    """What this process has left running: its live threads other than
    the main one (name, and whether a daemon), and its child processes
    (pid and command line, from /proc)."""
    import threading
    threads = [f"{t.name}{' (daemon)' if t.daemon else ''}"
               for t in threading.enumerate()
               if t is not threading.main_thread()]
    children = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != os.getpid():
                continue
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except (OSError, ValueError, IndexError):
            continue
        children.append(f"{pid} {cmd[:120].strip()}")
    return threads, children


def main(argv=None) -> int:
    t_script = time.perf_counter()
    clock = PhaseClock()
    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script drives the port on one GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    clock.phase("== phase 1: device facts")
    card = smi("name,power.limit")
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"  kernel build (nvcc, sm_90a, {len(_build.SOURCES)} sources in "
          f"parallel): {time.perf_counter() - t0:.2f} s")
    report, smem = {}, {}
    for name, log in logs.items():
        report.update(ptxas_report(log))
        smem.update(ptxas_smem(log))
        for line in log.splitlines():
            if "gf2_bitmatrix" in name and not ("wgmma" in line
                                                or "warning" in line):
                continue
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "wgmma", "warning")):
                print(f"  {name}: {line.strip()}")
    k4 = {fn: f for fn, f in report.items() if K4_INSTANCE.search(fn)}
    if logs["gf2_bitmatrix"]:
        check(len(k4) == 16, f"ptxas reported {len(k4)} K4 instances, "
              f"expected 16 (KS 1..4 x NI 1..4)")
        regs = [f["registers"] for f in k4.values()]
        spills = sum(f["spill_stores"] + f["spill_loads"]
                     for f in k4.values())
        print(f"  gf2_bitmatrix: {len(k4)} instances, {min(regs)}.."
              f"{max(regs)} registers, {spills} bytes spilled in all; "
              f"rows=k=16 instance: {k4_registers(report, 16, 16)}")
    else:
        print("  gf2_bitmatrix: library built before this run, no ptxas "
              "report")
    for fn, mix in sass_mix("gf256_transform").items():
        groups = re.search(r"ILi(\d+)E", fn)
        print(f"  gf256_transform SASS (cuobjdump -sass, static count), "
              f"instance for {groups.group(1) if groups else fn} group(s) "
              f"of 4 rows: {sum(mix.values())} instructions, "
              f"{dict(mix.most_common(12))}")
    main_instances = {k4_instance(r, gf.DATA_SHARDS) for r in (1, 4)}
    for fn, mix in sass_mix("gf2_bitmatrix").items():
        m = K4_INSTANCE.search(fn)
        inst = tuple(int(v) for v in m.groups()) if m else None
        if inst in main_instances:
            print(f"  gf2_bitmatrix SASS (cuobjdump -sass, static count), "
                  f"instance KS={inst[0]} NI={inst[1]}: "
                  f"{sum(mix.values())} instructions, "
                  f"{dict(mix.most_common(14))}")

    clock.phase("== phase 2: kernel vs plain version on the card")
    max_err = phase_kernel_vs_plain(dev, args.seed)
    stacked_err = phase_stacked_vs_plain(dev, args.seed)
    mxu_err = phase_mxu_vs_plain(dev, args.seed)
    crc_err = phase_crc32c_vs_plain(dev, args.seed)
    torch.cuda.empty_cache()

    clock.phase("== phase 3: flagship steps at full width")
    gf256_cuda.launches = 0
    flagship = phase_flagship(dev, args.seed, args.flagship_mib * MIB)
    check(flagship["launches"] == 3,
          f"flagship steps launched the kernel {flagship['launches']} "
          f"times, expected 3")
    time_flagship(flagship, card)
    del flagship
    torch.cuda.empty_cache()

    clock.phase("== phase 4: the volume path (encode, rebuild, decode, "
                "verify)")
    encoder = pl.get_encoder("gpu")
    gf256_cuda.launches = 0
    seen = phase_volume(encoder, dev, args.seed, args.volume_mib * MIB)
    main_launches = gf256_cuda.launches
    check(main_launches > 0, "the volume path never launched the kernel")
    check(check_volume_counts(seen) == main_launches,
          "launch count mismatch over the volume path")

    clock.phase("== phase 5: kernel timing")
    t = time_pipeline_block(dev, args.seed, card)
    t4 = time_mxu(dev, args.seed, card, report)
    parent_dir = args.parent_k5 or k5_parent_sources(
        os.path.join(ROOT, ".smoke_tree", "k5_parent"))
    parent_k5 = load_parent_k5(parent_dir) if parent_dir else None
    if parent_k5 is None:
        print(f"  K5's parent not timed: no --parent-k5 and no git history "
              f"with commit {K5_PARENT}")
    t5 = time_crc32c(dev, args.seed, card, report, parent=parent_k5,
                     smem=smem)

    clock.phase("== phase 6: the mesh path (parallel/mesh.py), one NCCL rank")
    with pdist.init(device="cuda"):
        gf256_cuda.launches = 0
        gf256_cuda.stacked_launches = 0
        mesh = phase_mesh(dev, args.seed, args.mesh_volumes,
                          args.mesh_mib * MIB)
        check(mesh["per_call"] == [2, 1, 1] and mesh["launches"] == 0,
              f"the mesh path launched the stacked entry "
              f"{mesh['per_call']} times per call (expected [2, 1, 1]: "
              f"full_cycle_step encode and rebuild, then each verify) and "
              f"gf256_transform {mesh['launches']} times (expected 0)")
        print(f"  launches on the mesh path: gf256_stacked_transform "
              f"{mesh['stacked_launches']} ({mesh['per_call']} per call), "
              f"gf256_transform {mesh['launches']}")
        t6 = time_mesh_blocks(mesh, dev, card)
        del mesh["encoded"], mesh["survivors"]
        time_mesh_step(mesh["device_mesh"], mesh["data"], dev)
        del mesh["data"]
    torch.cuda.empty_cache()

    clock.phase("== phase 7: the store tier (needle volume, EC volume, "
                "degraded reads, scrub)")
    store = phase_store(dev, args.seed, args.store_mib * MIB, card)
    store_launches = check_store_counts(store)
    print(f"  launches on the store path: {store_launches}, each step's "
          f"equal to its expected count {store['expected']}")
    time_recover_crossover(card)

    clock.phase("== phase 8: the volume server over HTTP (EC generate, "
                "degraded GETs, rebuild, verify, scrub)")
    shutil.rmtree(MXU_DIR, ignore_errors=True)
    os.makedirs(MXU_DIR)
    server = phase_server(dev, args.seed, args.server_mib * MIB, card,
                          keep_dir=MXU_DIR)
    server_launches = check_store_counts(server, "server path")
    print(f"  launches on the server path: {server_launches}, each step's "
          f"equal to its expected count {server['expected']}")
    # phase 11's EC volume: phase 8's, before phase 9 drops its links
    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    link_volume(MXU_DIR, CLUSTER_SRC, SERVER_VID)

    clock.phase("== phase 9: the volume server's MXU method over HTTP "
                "(SWTPU_TORCH_EC_METHOD=mxu: generate_batch, degraded GETs, "
                "scrub localization through K4)")
    mxu = phase_mxu_server(dev, args.seed, args.server_mib * MIB,
                           args.mxu_extra_mib * MIB, server, card)
    mxu_launches, mxu_calls = check_mxu_counts(mxu)
    mxu_k1 = sum(v["K1"] for v in mxu["launches"].values())
    print(f"  on the MXU path: K4 {mxu_launches} launches in {mxu_calls} "
          f"calls, K1 {mxu_k1} launches, each step's equal to its expected "
          f"count {mxu['expected']}")

    clock.phase("== phase 10: volume -workers 2 -ecBackend gpu (two "
                "processes, each with its own CUDA context, one shared port)")
    phase_workers(args.seed, args.workers_mib * MIB, card)

    clock.phase("== phase 11: the port's own cluster (master, two volume "
                "servers, shell, autopilot): ec.encode, degraded GETs, "
                "autopilot repair, ec.verify, ec.rebuild, ec.decode")
    cluster = phase_cluster(dev, args.seed, args.server_mib * MIB,
                            CLUSTER_SRC, limit_mb=args.server_mib,
                            card=card, parity_sha=server["parity_sha"])
    cluster_launches = check_store_counts(cluster, "cluster path")
    predicted = cluster_prediction(args.seed, args.server_mib * MIB)
    check(cluster["launches"] == predicted,
          f"phase 11 launched K1 {cluster['launches']} times per step; "
          f"the reckoning from the seed alone is {predicted}")
    bad = forbidden_loaded()
    check(bad == [], f"this process loaded {bad[:5]}")
    print(f"  launches on the cluster path: {cluster_launches}, each "
          f"step's equal to its expected count {cluster['expected']} and "
          f"to the reckoning from the seed alone; no module of jax or "
          f"seaweedfs_tpu in this process")

    clock.phase("== phase 12: the filer tier (filer.copy ingest, listings, "
                "GETs and Range GETs through the filer, ec.encode of its "
                "volume, 4 shards lost, filer restart, degraded reads "
                "through K1, fs.du, fs.meta.notify)")
    filer = phase_filer(dev, args.seed, args.server_mib * MIB, card=card)
    filer_launches = check_store_counts(filer, "filer path")
    predicted = filer_prediction(args.seed, args.server_mib * MIB)
    check(within_prediction(filer["launches"], predicted),
          f"phase 12 launched K1 {filer['launches']} times per step; the "
          f"reckoning from the seed alone is {predicted}")
    bad = forbidden_loaded()
    check(bad == [], f"this process loaded {bad[:5]}")
    print(f"  launches on the filer path: {filer_launches}, each step's "
          f"equal to its count from the .ecx {filer['expected']} and within "
          f"the reckoning from the seed alone {predicted}; no module of jax "
          f"or seaweedfs_tpu in this process")

    clock.phase("== phase 13: the gateways (server -filer -s3, a signed "
                "standalone s3, webdav, filer.replicate): writes, ec.encode "
                "of each collection, 4 shards lost, degraded reads through "
                "K1")
    gateway = phase_gateway(dev, args.seed, args.gateway_mib * MIB,
                            card=card)
    gateway_launches = check_store_counts(gateway, "gateway path")
    predicted = gateway_prediction(args.seed, args.gateway_mib * MIB)
    check(within_prediction(gateway["launches"], predicted),
          f"phase 13 launched K1 {gateway['launches']} times per step; the "
          f"reckoning from the seed alone is {predicted}")
    bad = forbidden_loaded()
    check(bad == [], f"this process loaded {bad[:5]}")
    print(f"  launches on the gateway path: {gateway_launches}, each step's "
          f"equal to its count from the .ecx {gateway['expected']} and "
          f"within the reckoning from the seed alone {predicted}; no module "
          f"of jax or seaweedfs_tpu in this process or its subprocesses")

    clock.phase("== phase 14: the FUSE mount (mount/, the /dev/fuse wire "
                "binding over a socketpair): a tree written and read back "
                "through FUSE requests, ec.encode of its collection, shards "
                "{0,3,7,9} lost, degraded READs through K1")
    mount = phase_mount(dev, args.seed, args.mount_mib * MIB, card=card)
    mount_launches = check_store_counts(mount, "mount path")
    predicted = mount_prediction(args.seed, args.mount_mib * MIB)
    check(mount["launches"] == predicted,
          f"phase 14 launched K1 {mount['launches']} times per step; the "
          f"reckoning from the seed alone is {predicted}")
    bad = forbidden_loaded()
    check(bad == [], f"this process loaded {bad[:5]}")
    print(f"  launches on the mount path: {mount_launches}, each step's "
          f"equal to its count from the .ecx {mount['expected']} and to the "
          f"reckoning from the seed alone; no module of jax or "
          f"seaweedfs_tpu in this process")

    clock.phase("== phase 15: the rebuild soak (seaweedfs_tpu_torch/tools/"
                "soak.py) on subprocess daemons: a master and 4 volume "
                "servers at -ecBackend auto, ec.encode, a SIGKILLed shard "
                "holder, ec.rebuild, three verify passes")
    phase_soak(card)

    clock.phase(None)
    threads, children = left_running()
    check(children == [], f"child processes left running: {children}")
    print(f"  left running at the end: threads {threads}, no child "
          f"process; {time.perf_counter() - t_script:.1f} s of script to "
          f"here")

    print(json.dumps({"kernels": [{
        "name": "gf256_transform", "route": "cuda",
        "source": "seaweedfs_tpu_torch/ops/csrc/gf256_transform.cu",
        "replaces": "seaweedfs_tpu/ops/gf256_pallas.py:69",
        "launches": main_launches + store_launches + server_launches
        + mxu_k1 + cluster_launches + filer_launches + gateway_launches
        + mount_launches,
        "max_abs_err": max(max_err, store["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None, "held_against_plain": True}, {
        "name": "gf256_stacked_transform", "route": "cuda",
        "source": "seaweedfs_tpu_torch/ops/csrc/gf256_transform.cu",
        "replaces": "seaweedfs_tpu/ops/gf256_pallas.py:120",
        "launches": mesh["stacked_launches"],
        "max_abs_err": max(stacked_err, mesh["max_abs_err"]),
        "ms": t6["ms"], "plain_ms": t6["plain_ms"],
        "bound_ms": t6["bound_ms"], "bound_by": t6["bound_by"],
        "library_ms": None, "held_against_plain": True}, {
        "name": "gf2_bitmatrix_transform", "route": "cuda",
        "source": "seaweedfs_tpu_torch/ops/csrc/gf2_bitmatrix.cu",
        "replaces": "seaweedfs_tpu/ops/gf256_mxu.py:62",
        "launches": mxu_launches, "calls": mxu_calls,
        "max_abs_err": mxu_err,
        "ms": t4["ms"], "plain_ms": t4["plain_ms"],
        "bound_ms": t4["bound_ms"], "bound_by": t4["bound_by"],
        "library_ms": None, "held_against_plain": True}, {
        "name": "crc32c_batch", "route": "cuda",
        "source": "seaweedfs_tpu_torch/ops/csrc/crc32c.cu",
        "replaces": "seaweedfs_tpu/ops/crc32c_jax.py:95",
        "launches": t5["launches"], "max_abs_err": crc_err,
        "ms": t5["ms"], "plain_ms": t5["plain_ms"],
        "bound_ms": t5["bound_ms"], "bound_by": t5["bound_by"],
        "library_ms": None, "held_against_plain": True}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
