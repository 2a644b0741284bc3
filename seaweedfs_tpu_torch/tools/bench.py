"""Benchmark: RS(10,4) erasure-coding throughput on the attached GPU.

The port of the JAX package's bench.py, run as `python -m
seaweedfs_tpu_torch.cli bench-ec` (or `python -m
seaweedfs_tpu_torch.tools.bench`; `--needle [ARG ...]` runs
tools/bench_needle.py's port instead).

ALWAYS prints exactly ONE JSON line on stdout, no matter what fails:
  {"metric": "...", "value": N, "unit": "GB/s", "vs_baseline": N, ...}

value      = sustained encode+rebuild data throughput per card (GB/s of
             data-shard bytes processed; min of encode and worst-case
             4-missing rebuild).
vs_baseline= ratio vs the host CPU encoder measured in the same run (the
             port's CpuEncoder, native AVX2 where it is built).

Robustness design:
  * All device work runs in a KILLABLE CHILD PROCESS (`python -m
    seaweedfs_tpu_torch.tools.bench --child`) with a wall-clock budget;
    a child that prints nothing within the init timeout is killed,
    retried once, then abandoned.
  * The child VERIFIES each kernel path on the card against the CPU
    oracle, at the first stage's bytes a shard, before timing it, and
    holds it again to its plain version on each later stage's own
    buffer; the batched encode and the CRC are held to theirs on the
    very inputs they are then timed on. A fast-but-wrong path is never
    reported. The paths keep the JAX package's names: "vpu" is the GF(256)
    nibble-table kernel (K1, ops/gf256_cuda.gf256_transform) on this
    card, "mxu" the GF(2) bit-matrix product on the int8 tensor cores
    (K4, ops/gf256_mxu.gf2_bitmatrix_transform).
  * Rates are data bytes a second; a rate whose bytes moved through
    HBM (BYTES_PER_DATA_BYTE) exceed the card's HBM rate raises
    ImplausibleResult instead of being reported. Every loop is timed
    over about a second or more, dispatched ahead with one synchronize,
    within the budget.
  * The child measures incrementally (small shapes first) and streams
    each cumulative result as a JSON line; the parent keeps the last
    complete one, so even a mid-measurement kill yields a real number.
  * When the child yields nothing, the line carries value 0.0, backend
    "none" and the error, and the process exits non-zero. Nothing falls
    back to the host encoder's rate: it stays in cpu_baseline_GBps.
  * The child ends by logging its kernel launches (K1, K2, K4, K5) on
    stderr, as one `launches {...}` line.
Progress is logged to stderr so a hang is diagnosable.

The stages of the JAX package's child are all here but its
`tune_block_bm`, which races the Pallas kernel's grid tile height: the
CUDA kernel K1 takes no block size (its grid is one wave of blocks,
sized from the batch), so there is nothing to race.

Env knobs (apart from the JAX package's SWTPU_BENCH_*):
  SWTPU_TORCH_BENCH_BUDGET_S   total wall-clock budget (default 420)
  SWTPU_TORCH_BENCH_INIT_S     child start-up timeout per attempt
                               (default 180)
  SWTPU_TORCH_BENCH_BYTES      max bytes per shard in the largest stage
  SWTPU_TORCH_BENCH_CHILD_S    the child's own deadline (set by the
                               parent)
  SWTPU_TORCH_EC_BACKEND=cpu   run the plain PyTorch versions on the
                               host (the CPU tests); else the card
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

_T0 = time.perf_counter()

BUDGET_ENV = "SWTPU_TORCH_BENCH_BUDGET_S"
INIT_ENV = "SWTPU_TORCH_BENCH_INIT_S"
BYTES_ENV = "SWTPU_TORCH_BENCH_BYTES"
CHILD_ENV = "SWTPU_TORCH_BENCH_CHILD_S"

METRIC = "rs_10_4_encode_rebuild_GBps_per_chip"

# the checkout root, which the child must be able to import from
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# Physical ceiling for PLAUSIBLE results: NVIDIA H100 80GB HBM3's memory
# rate (data sheet), 3.35e12 B/s. Every step must at least read its k*n
# input bytes from HBM, so a measured data-GB/s above this is a harness
# artifact, never a real number; it raises instead of being reported.
HBM_BYTES_PER_S = 3.35e12
HBM_BOUND_GBPS = HBM_BYTES_PER_S / 1e9

# The bytes each reported rate's work must move through HBM for every
# data byte it is credited with (each input read once, each output
# written once): a chain step of RS(10,4) reads 10 rows and writes 4,
# in encode as in the 4-lost rebuild; a batched encode reads 10 rows
# and writes the 14 of the full shard set; a CRC reads its rows (the
# 4-byte checksums left out).
BYTES_PER_DATA_BYTE = {"encode_GBps": 14 / 10, "rebuild4_GBps": 14 / 10,
                       "batched_encode_GBps": 24 / 10,
                       "crc_device_GBps": 1.0}


def ceiling_gbps(key: str) -> float:
    """The highest data rate under `key` the card's HBM rate allows."""
    return HBM_BOUND_GBPS / BYTES_PER_DATA_BYTE[key]


def _log(msg: str) -> None:
    print(f"[bench +{time.perf_counter() - _T0:6.1f}s] {msg}",
          file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# CPU baseline (parent process; it never touches the card)
# ---------------------------------------------------------------------------


def bench_cpu(n_bytes_per_shard: int = 4 << 20) -> tuple[float, str]:
    """Host baseline: the best available CPU encoder — the native AVX2
    kernel (native/gf256.c) when built, else the numpy table lookups."""
    from ..ec import gf
    from ..ec.encoder_cpu import CpuEncoder

    enc = CpuEncoder()
    kind = "native-avx2" if enc.use_native else "numpy"
    rng = np.random.default_rng(7)
    data = [rng.integers(0, 256, n_bytes_per_shard).astype(np.uint8)
            for _ in range(gf.DATA_SHARDS)]
    enc.encode(list(data))  # warm tables
    t0 = time.perf_counter()
    iters = 3
    for _ in range(iters):
        enc.encode(list(data))
    dt = (time.perf_counter() - t0) / iters
    return gf.DATA_SHARDS * n_bytes_per_shard / dt / 1e9, kind


def bench_degraded_read(n_needles: int = 64, payload: int = 8 << 10,
                        reads: int = 300) -> dict:
    """p50/p99 latency of EcVolume.read_needle with one data shard file
    deleted — every read reconstructs its intervals from the 13
    survivors. Host-path measurement: the CPU encoder throughout, so no
    device in the loop (the parent never initialises the card; that is
    the killable child's job)."""
    import shutil
    import tempfile

    from ..ec import pipeline as ecpl
    from ..ec.ec_volume import EcVolume
    from ..ec.encoder_cpu import CpuEncoder
    from ..storage.needle import Needle
    from ..storage.volume import Volume

    enc = CpuEncoder()
    tmp = tempfile.mkdtemp(prefix="swtpu_torch_bench_ec_")
    try:
        v = Volume(tmp, "", 1)
        rng = np.random.default_rng(11)
        for i in range(1, n_needles + 1):
            v.write_needle(Needle(cookie=0x1234, id=i,
                                  data=rng.integers(0, 256, payload)
                                  .astype(np.uint8).tobytes()))
        v.close()
        base = os.path.join(tmp, "1")
        ecpl.write_ec_files(base, encoder=enc)
        ecpl.write_sorted_file_from_idx(base)
        os.remove(base + ".ec00")  # lose a data shard
        ev = EcVolume(tmp, "", 1, encoder=enc)
        lat = []
        for r in range(reads):
            nid = (r % n_needles) + 1
            t0 = time.perf_counter()
            n = ev.read_needle(nid)
            lat.append((time.perf_counter() - t0) * 1e3)
            assert len(n.data) == payload
        ev.close()
        lat.sort()
        return {
            "degraded_read_p50_ms": round(lat[len(lat) // 2], 3),
            "degraded_read_p99_ms": round(lat[int(len(lat) * 0.99)], 3),
            "degraded_read_reads": reads,
        }
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Child: all device work. Streams cumulative JSON results line-by-line.
# ---------------------------------------------------------------------------


def _emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def kernel_paths(dev) -> dict:
    """{"vpu": K1, "mxu": K4}, each a step(coeff, x, out) that applies a
    (rows, k) GF(256) matrix to the (B, k, L) view x into the (B, rows, L)
    view out, launched on the current stream."""
    from ..ec.encoder_torch import device_consts
    from ..ops import gf256_mxu as gm
    from ..ops.gf256_cuda import gf256_transform

    return {
        "vpu": lambda c, x, out: gf256_transform(device_consts(c, dev), x,
                                                 out=out),
        "mxu": lambda c, x, out: gm.gf2_bitmatrix_transform(
            gm.device_bitmatrix(c, dev), x, out=out),
    }


def chain_views(buf, k: int, rows: int, step: int):
    """The (x, out) views of chain step `step` over a (B, k + rows, L)
    buffer: even steps read rows rows..rows+k-1 into rows 0..rows-1, odd
    steps rows 0..k-1 into k..k+rows-1. Each step's inputs hold the rows
    the step before wrote, no step's output overlaps its inputs, and
    nothing is copied between steps."""
    if step % 2 == 0:
        return buf[:, rows:rows + k], buf[:, :rows]
    return buf[:, :k], buf[:, k:k + rows]


def _verify_paths_on_device(dev, n_small: int = 4 << 20,
                            paths: dict | None = None) -> dict:
    """Encode+rebuild a slab on the card with each kernel path and
    compare byte-for-byte against the CPU oracle. The check runs the
    layout and the size that are then timed first: (1, k + rows,
    n_small) chain buffers (the child passes its first stage's bytes a
    shard), encode on an even step's views and rebuild on an odd step's.
    Returns {path: True|err}."""
    import torch

    from ..ec import gf
    from ..ec.encoder_cpu import CpuEncoder

    rng = np.random.default_rng(3)
    k = gf.DATA_SHARDS
    data = [rng.integers(0, 256, n_small).astype(np.uint8) for _ in range(k)]
    oracle = CpuEncoder(use_native=False)
    reb_coeff = gf.shard_rows([0, 1, 2, 3], list(range(4, 14)))
    full = oracle.encode(list(data))
    want_parity = np.stack(full[k:])
    want_reb = np.stack(oracle._apply_numpy(reb_coeff, full[4:14]))
    enc_coeff = gf.parity_matrix()
    rows = enc_coeff.shape[0]
    status: dict = {}
    for name, fn in (paths or kernel_paths(dev)).items():
        try:
            buf = torch.zeros((1, k + rows, n_small), dtype=torch.uint8,
                              device=dev)
            x, out = chain_views(buf, k, rows, 0)
            x.copy_(torch.from_numpy(np.stack(data))[None])
            fn(enc_coeff, x, out)
            got_p = out[0].cpu().numpy().copy()
            x, out = chain_views(buf, k, rows, 1)
            x.copy_(torch.from_numpy(np.stack(full[4:14]))[None])
            fn(reb_coeff, x, out)
            got_r = out[0].cpu().numpy().copy()
            ok = (np.array_equal(got_p, want_parity)
                  and np.array_equal(got_r, want_reb))
            status[name] = True if ok else "MISMATCH vs CPU oracle"
        except Exception as e:  # noqa: BLE001 — one path must not kill both
            status[name] = f"{type(e).__name__}: {e}"[:200]
        _log(f"oracle check {name} ({n_small}B/shard): {status[name]}")
    return status


def _roundtrip_latency(dev) -> float:
    """Per-dispatch round-trip cost: one tiny launch and a synchronize."""
    import torch

    z = torch.zeros((8, 128), dtype=torch.int32, device=dev)
    z.add_(1)
    _sync(dev)
    t0 = time.perf_counter()
    iters = 5
    for _ in range(iters):
        z.add_(1)
        _sync(dev)
    return (time.perf_counter() - t0) / iters


class ImplausibleResult(Exception):
    pass


def check_plausible(key: str, gbs: float) -> None:
    """Raise ImplausibleResult where the bytes a data rate under `key`
    moves (BYTES_PER_DATA_BYTE) would exceed the card's HBM rate."""
    if gbs > ceiling_gbps(key):
        raise ImplausibleResult(
            f"{key} {gbs:.0f} GB/s moves "
            f"{gbs * BYTES_PER_DATA_BYTE[key]:.0f} GB/s, above the "
            f"{HBM_BOUND_GBPS:.0f} GB/s HBM ceiling — measurement "
            f"artifact, not reported")


def _chained_gbs(step, coeff, buf, n: int, chain_len: int, rtt: float,
                 budget_s: float | None = None
                 ) -> tuple[float, float, int]:
    """Sustained GB/s of data-shard bytes through the kernel.

    `buf` is a (B, k + rows, n) chain buffer and step(coeff, x, out) one
    launch; chain_len dependent launches make one chain (each reads what
    the one before wrote, `chain_views`), and several chains are then
    DISPATCHED AHEAD on one stream with one synchronize at the end.

    Measurement honesty rules:
      * nothing is ever subtracted from a timing — any dispatch overhead
        that dispatching ahead fails to hide is COUNTED, so the number
        can only understate the kernel;
      * a chain too short to measure is grown, not corrected, and the
        rate divides by the chain length that actually ran;
      * any result above the HBM ceiling raises ImplausibleResult.
    budget_s, when given, caps the wall clock this call may spend.
    Returns (gbs, total timed seconds, chain_len actually used).
    """
    rows = coeff.shape[0]
    bsz, total, _ = buf.shape
    k = total - rows
    dev = buf.device
    t_entry = time.perf_counter()
    state = {"step": 0}

    def spent() -> float:
        return time.perf_counter() - t_entry

    def chain(cl: int) -> None:
        for _ in range(cl):
            x, out = chain_views(buf, k, rows, state["step"])
            step(coeff, x, out)
            state["step"] += 1

    for _attempt in range(4):
        used_cl = chain_len  # the length the chain ACTUALLY runs: every
        #                      timing below divides by this, never by a
        #                      post-growth value
        chain(used_cl)  # warm
        _sync(dev)
        t0 = time.perf_counter()
        chain(used_cl)
        _sync(dev)
        dt1 = time.perf_counter() - t0
        if dt1 > 5 * rtt or used_cl >= 256:
            break
        if budget_s is not None and spent() > budget_s / 3:
            break
        # chain too short for one dispatch to dominate its own rtt:
        # grow it (bounded) so the loop below isn't dispatch-bound
        grow = max(2, int(5 * rtt / max(dt1, 1e-6)) + 1)
        chain_len = min(256, used_cl * grow)
        _log(f"  chain too short (dt={dt1 * 1e3:.3f}ms vs rtt="
             f"{rtt * 1e3:.3f}ms); growing chain to {chain_len}")
    # dispatch-ahead: enough chains that the timed region spans >= ~10
    # rtts and ~1 s of kernel time, synchronising only after the last.
    # The subtraction here only SIZES the loop; the reported figure
    # divides the full measured dt.
    est_step = max(dt1 - rtt, dt1 / 4, 1e-6)
    target = max(1.0, 10 * rtt)
    iters = max(2, int(target / est_step) + 1)
    if budget_s is not None:
        # the cap uses the conservative blocking time dt1: launches
        # return at once, so the final synchronize may block for all of
        # iters * the real step
        iters = min(iters,
                    max(2, int(max(budget_s - spent(), 0.0) / dt1) + 1))
    iters = min(iters, 100_000)
    t0 = time.perf_counter()
    done = 0
    for _ in range(iters):
        chain(used_cl)
        done += 1
        # hard deadline: dividing by the count actually dispatched keeps
        # the figure honest
        if done >= 2 and budget_s is not None and spent() > budget_s:
            break
    _sync(dev)  # single sync point
    dt = time.perf_counter() - t0
    per_step = dt / (done * used_cl)
    gbs = bsz * k * n / per_step / 1e9
    # a step reads its k rows and writes its rows rows
    if gbs * (k + rows) / k > HBM_BOUND_GBPS:
        raise ImplausibleResult(
            f"{gbs:.0f} GB/s of data moves {gbs * (k + rows) / k:.0f} GB/s, "
            f"above the {HBM_BOUND_GBPS:.0f} GB/s HBM ceiling "
            f"(dt={dt * 1e3:.1f}ms chain={used_cl} iters={done}) — "
            f"measurement artifact, not reported")
    return gbs, dt, used_cl


def _timed_calls(call, dev, budget_s: float, target_s: float = 1.0
                 ) -> tuple[float, int]:
    """Seconds per call of call(), and the calls timed. After a warm call,
    rounds of calls are dispatched ahead with one synchronize at the end
    of each; a round shorter than target_s is followed by a longer one,
    sized from it, until one spans target_s or the budget (or 100,000
    calls) allows no longer. The last round's whole measured time is
    divided by its own count."""
    t_entry = time.perf_counter()
    call()  # warm
    _sync(dev)
    iters = 2
    while True:
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        _sync(dev)
        dt = time.perf_counter() - t0
        per_call = max(dt / iters, 1e-9)
        left = budget_s - (time.perf_counter() - t_entry)
        # 1.2x the target, so that the next round seldom falls short
        want = min(int(1.2 * target_s / per_call) + 1, int(left / per_call),
                   100_000)
        if dt >= target_s or want <= iters:
            return dt / iters, iters
        iters = want


def bench_batched(dev, max_bytes: int, budget_s: float) -> dict:
    """The batched rack encode: V volumes in one call of
    parallel/mesh.batched_encode on a one-rank group (K2 in its block),
    NCCL on the card and gloo on the host, over a file:// rendezvous in
    a temporary directory. Its result is held to the plain version
    (gf256_stacked_transform_reference) on the same volumes before
    anything is timed; a mismatch is reported and never timed. Returns
    the stage's keys."""
    import shutil
    import tempfile

    import torch

    from ..ec import gf
    from ..ec.encoder_torch import device_consts
    from ..ops.gf256_cuda import gf256_stacked_transform_reference
    from ..parallel import dist as pdist
    from ..parallel import mesh as pmesh

    k = gf.DATA_SHARDS
    vb, nb = (8, 16 << 20) if dev.type == "cuda" else (4, 256 << 10)
    nb = min(nb, max_bytes)
    tmp = tempfile.mkdtemp(prefix="swtpu_torch_bench_rdzv_")
    try:
        with pdist.init(device=dev.type,
                        init_method="file://" + os.path.join(tmp, "rdzv")):
            m = pmesh.make_mesh()
            _log("batched encode: one-rank group and mesh up")
            g = torch.Generator(device=dev)
            g.manual_seed(1)
            vol_data = torch.randint(0, 256, (vb, k, nb), dtype=torch.uint8,
                                     device=dev, generator=g)
            got = pmesh.batched_encode(m, vol_data)
            want = gf256_stacked_transform_reference(
                device_consts(gf.parity_matrix(), dev), vol_data)
            if not (torch.equal(got[:, :k], vol_data)
                    and torch.equal(got[:, k:], want)):
                raise RuntimeError(f"MISMATCH vs plain version at "
                                   f"({vb}, {k}, {nb})")
            del got, want
            _log("batched encode: held to its plain version")
            per_call, iters = _timed_calls(
                lambda: pmesh.batched_encode(m, vol_data), dev, budget_s)
            del vol_data
        gbs = vb * k * nb / per_call / 1e9
        check_plausible("batched_encode_GBps", gbs)
        _log(f"batched encode {vb}x{nb >> 20}MB iters={iters}: "
             f"{gbs:.2f} GB/s")
        return {"batched_encode_GBps": round(gbs, 2),
                "batched_encode_iters": iters}
    except Exception as e:  # noqa: BLE001
        _log(f"batched encode FAILED: {type(e).__name__}: {e}")
        return {"batched_encode_error": f"{type(e).__name__}: {e}"[:200]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bench_crc(dev, max_bytes: int, budget_s: float) -> dict:
    """Device CRC32C (ops/crc32c_cuda.crc32c_batch, K5) against the host
    SSE4.2 path — whether folding checksums into the device pipeline
    pays. Every row is held to the host's CRC32C first (which also
    times the host); a mismatch is reported and never timed. Returns
    the stage's keys."""
    import torch

    from ..ops.crc32c_cuda import crc32c_batch
    from ..util import crc32c as hostcrc

    try:
        bsz, n = (64, 1 << 20) if dev.type == "cuda" else (4, 64 << 10)
        n = min(n, max(max_bytes, 64 << 10))
        g = torch.Generator(device=dev)
        g.manual_seed(5)
        data = torch.randint(0, 256, (bsz, n), dtype=torch.uint8,
                             device=dev, generator=g)
        got = crc32c_batch(data).cpu().tolist()
        host = data.cpu().numpy()
        t0 = time.perf_counter()
        want = [hostcrc.crc32c(r.tobytes()) for r in host]
        host_gbs = bsz * n / (time.perf_counter() - t0) / 1e9
        if got != want:
            raise RuntimeError("device crc mismatch vs host oracle")
        per_call, iters = _timed_calls(lambda: crc32c_batch(data), dev,
                                       budget_s)
        gbs = bsz * n / per_call / 1e9
        check_plausible("crc_device_GBps", gbs)
        _log(f"crc32c device {gbs:.2f} GB/s iters={iters} vs host "
             f"{host_gbs:.2f}")
        return {"crc_device_GBps": round(gbs, 3), "crc_iters": iters,
                "crc_host_GBps": round(host_gbs, 3)}
    except Exception as e:  # noqa: BLE001
        _log(f"crc32c FAILED: {type(e).__name__}: {e}")
        return {"crc_error": f"{type(e).__name__}: {e}"[:200]}


def kernel_launches() -> dict:
    """The launch counters of the port's four kernels (ops/ wrappers)."""
    from ..ops import crc32c_cuda, gf256_cuda, gf256_mxu
    return {"gf256_transform": gf256_cuda.launches,
            "gf256_stacked_transform": gf256_cuda.stacked_launches,
            "gf2_bitmatrix_transform": gf256_mxu.launches,
            "crc32c_batch": crc32c_cuda.launches}


LAUNCHES_TAG = "launches "


def child_main() -> int:
    deadline = _T0 + float(os.environ.get(CHILD_ENV, "300"))

    def left() -> float:
        return deadline - time.perf_counter()

    import torch

    from ..ec.pipeline import get_encoder

    # the card, unless SWTPU_TORCH_EC_BACKEND=cpu asks for the host
    try:
        dev = get_encoder().device
    except RuntimeError as e:
        _emit({"stage": "init", "backend": "none", "error": str(e)[:300]})
        return 1
    backend = "gpu" if dev.type == "cuda" else "cpu"
    if backend == "gpu":
        dev = torch.device("cuda", torch.cuda.current_device())
    _log(f"backend up: {backend} device={dev}"
         + (f" ({torch.cuda.get_device_name(dev)})" if backend == "gpu"
            else ""))
    _emit({"stage": "init", "backend": backend})
    # tiny-transfer probe BEFORE any real device work
    t0 = time.perf_counter()
    probe = torch.arange(256, dtype=torch.uint8).to(dev)
    if int(probe.to(torch.int32).sum()) != 255 * 128:
        raise RuntimeError("the tiny-transfer probe read back wrong bytes")
    _log(f"tiny-transfer probe ok ({time.perf_counter() - t0:.2f}s)")
    _emit({"stage": "probe", "probe_s": round(time.perf_counter() - t0, 2)})

    from ..ec import gf
    from ..ec.encoder_torch import device_consts
    from ..ops.gf256_cuda import gf256_transform_reference

    max_bytes = int(os.environ.get(
        BYTES_ENV, str((256 << 20) if backend == "gpu" else (1 << 20))))
    # chains sized so the timed region dwarfs the dispatch rtt (the
    # adaptive growth in _chained_gbs backstops this)
    stages = [(s, c) for s, c in [
        (4 << 20, 64), (16 << 20, 32), (64 << 20, 32),
        (256 << 20, 16)] if s <= max_bytes]
    if not stages:  # tiny SWTPU_TORCH_BENCH_BYTES: still measure one stage
        stages = [(max(128 << 10, (max_bytes // (128 << 10)) * (128 << 10)),
                   2)]

    status = _verify_paths_on_device(dev, n_small=stages[0][0])
    _emit({"stage": "oracle", "paths_verified": status})
    good = [p for p, st in status.items() if st is True]
    if not good:
        _emit({"stage": "done", "error": f"no kernel path passed the "
               f"on-device oracle check: {status}"})
        _log(LAUNCHES_TAG + json.dumps(kernel_launches()))
        return 0

    rtt = _roundtrip_latency(dev)
    _log(f"dispatch rtt {rtt * 1e3:.4f} ms")

    enc_coeff = gf.parity_matrix()
    # worst-case rebuild: all 4 lost are data shards, rebuilt from
    # shards 4..13 (6 data + 4 parity)
    reb_coeff = gf.shard_rows([0, 1, 2, 3], list(range(4, 14)))
    paths = kernel_paths(dev)
    detail: dict = {"dispatch_rtt_ms": round(rtt * 1e3, 4)}

    k = gf.DATA_SHARDS
    rows = enc_coeff.shape[0]
    speeds: dict[str, float] = {}  # path -> best measured GB/s so far

    def emit_cumulative(n: int) -> None:
        """Stream the best-so-far result after EVERY measurement, so a
        budget kill can never lose numbers already measured."""
        enc = max((v for d, v in detail.items()
                   if d.startswith("encode_") and isinstance(v, float)),
                  default=0.0)
        reb = max((v for d, v in detail.items()
                   if d.startswith("rebuild4_") and isinstance(v, float)),
                  default=0.0)
        # "value" only once BOTH ops are measured; null again if a path
        # found wrong later took its rates out
        _emit({"stage": f"measure_{n >> 20}MB", "backend": backend,
               "encode_GBps": enc, "rebuild4_GBps": reb, "paths": detail,
               "value": min(enc, reb) if enc > 0 and reb > 0 else None})

    def gen_buffer(n: int, seed: int = 0):
        # generated ON the card: no host copy of GBs of stripes
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        return torch.randint(0, 256, (1, k + rows, n), dtype=torch.uint8,
                             device=dev, generator=g)

    def chain_for(name: str, n: int, default: int) -> int:
        # size the chain from the measured speed so the timed region
        # lands near max(0.7s, 12*rtt) on the first try
        if name not in speeds:
            return default
        per_step = k * n / (speeds[name] * 1e9)
        return min(256, max(4, int(max(0.7, 12 * rtt) / per_step) + 1))

    def matches_plain(name: str, buf) -> bool:
        """Hold path `name` to the plain version on the card, on the
        stage's own buffer, at both matrices; a path found wrong is
        reported, its rates are taken out and it is never timed again."""
        for coeff in (enc_coeff, reb_coeff):
            x, out = chain_views(buf, k, rows, 0)
            paths[name](coeff, x, out)
            if not torch.equal(out, gf256_transform_reference(
                    device_consts(coeff, dev), x)):
                break
        else:
            return True
        n = buf.shape[2]
        status[name] = f"MISMATCH vs plain version at {n} B a shard"
        _log(f"{name}: {status[name]}")
        good.remove(name)
        speeds.pop(name, None)
        for key in [d for d in detail if d.split("_")[1:2] == [name]]:
            del detail[key]
        _emit({"stage": "oracle", "paths_verified": status})
        emit_cumulative(n)
        return False

    def run_stage(n: int, chain_len: int) -> None:
        buf = gen_buffer(n)
        best = max(speeds.values(), default=0.0)
        for name in sorted(good, key=lambda p: -speeds.get(p, 1e9)):
            if speeds.get(name, 1e9) < best / 5:
                # this path lost the race decisively at a smaller stage;
                # spend the remaining budget on the winner's curve
                _log(f"skipping {name} at {n >> 20}MB (lost race: "
                     f"{speeds[name]:.1f} vs {best:.1f} GB/s)")
                continue
            if not matches_plain(name, buf):
                continue
            cl = chain_for(name, n, chain_len)
            for op, coeff in (("encode", enc_coeff), ("rebuild4", reb_coeff)):
                if left() < 15:
                    return
                try:
                    gbs, dt, used_chain = _chained_gbs(
                        paths[name], coeff, buf, n, cl, rtt,
                        budget_s=left() - 10)
                except Exception as e:  # noqa: BLE001
                    detail[f"{op}_{name}_error"] = str(e)[:200]
                    _log(f"{op}/{name} n={n >> 20}MB FAILED: {e}")
                    continue
                key = f"{op}_{name}"
                detail[key] = max(detail.get(key, 0.0), round(gbs, 2))
                detail[f"{key}_{n >> 20}MB"] = round(gbs, 2)
                speeds[name] = max(speeds.get(name, 0.0), gbs)
                _log(f"{op}/{name} n={n >> 20}MB chain={used_chain} "
                     f"dt={dt * 1e3:.0f}ms: {gbs:.2f} GB/s")
                emit_cumulative(n)
        del buf

    # schedule: the first stage decides the kernel race, then the batched
    # config runs EARLY, then the winner's size curve, then the CRC
    if stages:
        run_stage(*stages[0])
    if left() > 25:
        _emit({"stage": "batched",
               **bench_batched(dev, max_bytes, left() - 20)})
    for n, chain_len in stages[1:]:
        if left() < 30:
            _log(f"budget exhausted before stage n={n >> 20}MB — stopping")
            break
        run_stage(n, chain_len)
    if left() > 45:
        _emit({"stage": "crc", **bench_crc(dev, max_bytes, left() - 40)})
    _log(LAUNCHES_TAG + json.dumps(kernel_launches()))
    _emit({"stage": "done", "backend": backend})
    return 0


# ---------------------------------------------------------------------------
# Parent: spawn/kill child, merge its stream, ALWAYS print the final line.
# ---------------------------------------------------------------------------


def child_command() -> list[str]:
    return [sys.executable, "-m", "seaweedfs_tpu_torch.tools.bench",
            "--child"]


def _run_child(budget_s: float, init_s: float) -> tuple[dict, str | None]:
    """Run the child under a wall-clock budget. Returns (merged result,
    error string or None). Kills the child if it produces nothing within
    init_s (a wedged start-up) or overruns budget_s."""
    merged: dict = {}
    err: str | None = None
    path = os.environ.get("PYTHONPATH")
    # a group of one over its own rendezvous: no inherited rank
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update({CHILD_ENV: str(max(budget_s - 5, 30)),
                "PYTHONPATH": REPO if not path else REPO + os.pathsep + path})
    # the child's stderr is this process's own file descriptor 2
    proc = subprocess.Popen(child_command(), stdout=subprocess.PIPE,
                            stderr=None, text=True, env=env, cwd=REPO)
    lines: list[str] = []
    lock = threading.Lock()

    def reader() -> None:
        for line in proc.stdout:  # type: ignore[union-attr]
            with lock:
                lines.append(line)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    start = time.perf_counter()
    saw_output = False
    while True:
        alive = proc.poll() is None
        with lock:
            pending, lines = lines, []
        for line in pending:
            saw_output = True
            try:
                merged.update(json.loads(line))
            except json.JSONDecodeError:
                pass
        waited = time.perf_counter() - start
        if not alive:
            if proc.returncode != 0 and not merged.get("value"):
                err = f"child exited rc={proc.returncode}"
            break
        if not saw_output and waited > init_s:
            err = f"backend init produced nothing in {init_s:.0f}s — killed"
            proc.kill()
            break
        if waited > budget_s:
            err = (None if merged.get("value")
                   else f"budget {budget_s:.0f}s exceeded — killed")
            _log(f"child overran budget {budget_s:.0f}s; killing "
                 f"(have partial result: {bool(merged.get('value'))})")
            proc.kill()
            break
        time.sleep(0.5)
    proc.wait(timeout=10)
    # final drain: lines still in the pipe when the loop broke
    th.join(timeout=5)
    with lock:
        pending, lines = lines, []
    for line in pending:
        try:
            merged.update(json.loads(line))
        except json.JSONDecodeError:
            pass
    if err and err.startswith("child exited") and merged.get("value"):
        err = None
    return merged, err


# the child's keys the final line carries
MERGED_KEYS = ("encode_GBps", "rebuild4_GBps", "paths", "paths_verified",
               "batched_encode_GBps", "batched_encode_iters",
               "batched_encode_error", "crc_device_GBps", "crc_iters",
               "crc_host_GBps", "crc_error")


def main() -> int:
    """Print the one JSON line; 0 when the child measured a value, else
    1 (value 0.0, backend "none")."""
    budget = float(os.environ.get(BUDGET_ENV, "420"))
    init_s = float(os.environ.get(INIT_ENV, "180"))
    result = {
        "metric": METRIC,
        "value": 0.0,
        "unit": "GB/s",
        "vs_baseline": 0.0,
        "backend": "none",
    }
    try:
        cpu_gbs, cpu_kind = bench_cpu()
        result["cpu_baseline_GBps"] = round(cpu_gbs, 3)
        result["cpu_baseline_kind"] = cpu_kind
        _log(f"cpu baseline: {cpu_gbs:.3f} GB/s ({cpu_kind})")
    except Exception as e:  # noqa: BLE001
        cpu_gbs = 0.0
        result["cpu_error"] = f"{type(e).__name__}: {e}"[:300]
        _log(f"cpu baseline FAILED: {e}")

    try:
        dr = bench_degraded_read()
        result.update(dr)
        _log(f"degraded read p50={dr['degraded_read_p50_ms']}ms "
             f"p99={dr['degraded_read_p99_ms']}ms")
    except Exception as e:  # noqa: BLE001
        result["degraded_read_error"] = f"{type(e).__name__}: {e}"[:300]
        _log(f"degraded-read bench FAILED: {e}")

    merged: dict = {}
    err: str | None = None
    try:
        remaining = budget - (time.perf_counter() - _T0)
        merged, err = _run_child(remaining, min(init_s, remaining))
        if err and not merged.get("value"):
            remaining = budget - (time.perf_counter() - _T0)
            if remaining > 90:
                _log(f"retrying child once ({err}); {remaining:.0f}s left")
                merged, err2 = _run_child(remaining,
                                          min(init_s, remaining - 30))
                err = err2 or err
    except Exception as e:  # noqa: BLE001 — the JSON line must still print
        err = f"{type(e).__name__}: {e}"[:300]

    measured = bool(merged.get("value")) and merged.get("backend") not in (
        None, "none")
    if measured:
        result["backend"] = merged["backend"]
        result["value"] = round(float(merged["value"]), 2)
        for key in MERGED_KEYS:
            if key in merged:
                result[key] = merged[key]
        if cpu_gbs > 0:
            result["vs_baseline"] = round(result["value"] / cpu_gbs, 2)
    else:
        # the card yielded nothing: value stays 0.0 and backend "none";
        # the host's rate stays in cpu_baseline_GBps, never in value
        if "paths_verified" in merged:
            result["paths_verified"] = merged["paths_verified"]
        if not err and not merged.get("error"):
            err = "the child measured no value"
    if err:
        result["error"] = err
    if merged.get("error"):
        result["error"] = (result.get("error", "") + "; " +
                           merged["error"]).strip("; ")

    try:
        from ..stats import metrics
        if metrics.HAVE_PROMETHEUS:
            metrics.EC_THROUGHPUT.set(result["value"])
    except Exception:  # noqa: BLE001
        pass
    print(json.dumps(result), flush=True)
    return 0 if measured else 1


def run(argv: list[str]) -> int:
    if "--child" in argv:
        return child_main()
    if "--needle" in argv:
        # the needle data-plane benchmark incl. the -workers sweep
        from . import bench_needle
        bench_needle.main([a for a in argv if a != "--needle"])
        return 0
    return main()


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
