"""Repair-bandwidth + stripe-batch benchmark for the EC tier.

The port of the JAX package's tools/bench_ec.py, on the port's EC tier:
the same modes, seeds, sizes, RemoteCounter accounting and assertions.
Every transform runs on the port's `get_encoder()`: the card (K1, the
CUDA kernel of ops/gf256_cuda.py) unless SWTPU_TORCH_EC_BACKEND=cpu
asks for its plain PyTorch version on the host. Where the reference
injects its host encoder (`get_encoder("cpu")`), the port injects its
own `get_encoder()`, so the recovers, rebuilds, encodes and scrubs of
every mode run on the card.

Measures the costs ROADMAP items 2+3 target, before/after style:

* **degraded reads** — drive N needle reads whose stripes touch lost
  shards through (a) the pre-PR *all-survivor gather* baseline (fixed
  sid-order row set, locality-blind — reimplemented here so the
  shipped path carries no dead code) and (b) the shipped minimal-fetch
  plan (`EcVolume.read_needle`). Reports bytes-moved-per-byte-repaired,
  repair GB/s and p50/p99 latency for both; the plan must move
  STRICTLY fewer bytes (arxiv 2306.10528's selection win).
* **whole-volume rebuild** — rebuild M lost shards sequentially (one
  full survivor pass per shard, the pre-batching shape) vs batched
  (one coefficient-matrix dispatch per window block), byte-verifying
  both against the originals; reports GB/s and the speedup.
* **backend bake-off** (`--mode bakeoff`) — every available encoder
  backend (cpu-numpy / cpu-native / torch-gpu) runs batched encode, verify
  and reconstruct over the same (B, 10, L) window blocks: encode GB/s
  (wall-clock, informational), dispatches-per-GB batched vs
  per-window (deterministic), and a repair-bandwidth reconstruct row
  — gated on byte-identity against the per-window numpy oracle. Also
  measures the host-vs-device recover crossover that keeps the
  `-ec.smallrecover` default honest.
* **engine accounting** (`--mode engine`) — the stripe-batch engine's
  deterministic dispatch/pread contract on a REAL volume:
  `encode_volume`, `EcVolume.verify_parity` and `rebuild_ec_files`
  at batch 1 vs batch B must be byte-identical with <= ceil(W/B)
  transform dispatches and strictly fewer preads at B >= 8.

Topology model (degraded mode): parity shards are local, lost shards
are gone, the remaining data shards live on --holders emulated remote
holders; every remote interval fetched is counted (bytes + per-holder
round trips) by the same fetch hooks the volume server injects.

    python -m seaweedfs_tpu_torch.tools.bench_ec           # full run
                                                           # (32 MB)
    python -m seaweedfs_tpu_torch.tools.bench_ec --smoke   # ~4 MB:
                                                # plan < naive bytes,
                                                # batched dispatch/pread
                                                # counts, byte-identity
                                                # across backends
    python -m seaweedfs_tpu_torch.tools.bench_ec --json out.json
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys
import tempfile
import time

import numpy as np

from ..ec import gf
from ..ec import pipeline as pl
from ..ec.ec_volume import EcVolume
from ..ec.locate import locate_data
from ..storage import types as t
from ..storage.needle import Needle
from ..storage.volume import Volume
from ..util.chunk_cache import EcRecoverCache

LB = 256 * 1024      # large block — small enough that a bench volume
SB = 16 * 1024       # small block   exercises both areas quickly
VID = 7


def build_volume(d: str, size_mb: float, rng: random.Random) -> dict:
    """Random needles totalling ~size_mb; returns {nid: (cookie, data)}."""
    v = Volume(d, "", VID)
    contents: dict = {}
    nid = 0
    target = int(size_mb * (1 << 20))
    while v.data_size() < target:
        nid += 1
        data = rng.randbytes(rng.randint(2048, 24576))
        cookie = rng.getrandbits(32)
        v.write_needle(Needle(cookie=cookie, id=nid, data=data))
        contents[nid] = (cookie, data)
    v.close()
    base = os.path.join(d, str(VID))
    enc = pl.get_encoder()
    pl.write_ec_files(base, encoder=enc, large_block=LB, small_block=SB,
                      buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    return contents


class RemoteCounter:
    """Emulated remote holders: serves shard intervals from files moved
    to a side directory, counting every byte and round trip — the same
    accounting shape as the volume server's per-holder batch gather."""

    def __init__(self, remote_dir: str, base: str, sids: list[int],
                 holders: int):
        self.dir = remote_dir
        self.base = base
        self.holder_of = {sid: f"holder{i % holders}"
                          for i, sid in enumerate(sorted(sids))}
        self.bytes_fetched = 0
        self.round_trips = 0
        self.intervals = 0
        self.max_batch_rows = 0

    def _path(self, sid: int) -> str:
        return os.path.join(self.dir,
                            os.path.basename(self.base) + pl.to_ext(sid))

    def fetch(self, sid: int, off: int, size: int) -> bytes | None:
        p = self._path(sid)
        if not os.path.exists(p):
            return None
        self.round_trips += 1
        self.intervals += 1
        self.bytes_fetched += size
        with open(p, "rb") as f:
            f.seek(off)
            raw = f.read(size)
        return raw + b"\x00" * (size - len(raw))

    def fetch_batch(self, reads) -> dict:
        out = {}
        holders = set()
        self.max_batch_rows = max(self.max_batch_rows, len(reads))
        for sid, off, size in reads:
            p = self._path(sid)
            if not os.path.exists(p):
                continue
            holders.add(self.holder_of.get(sid, "holder?"))
            self.intervals += 1
            self.bytes_fetched += size
            with open(p, "rb") as f:
                f.seek(off)
                raw = f.read(size)
            out[sid] = raw + b"\x00" * (size - len(raw))
        self.round_trips += len(holders)
        return out


def split_layout(src: str, work: str, local_sids: list[int],
                 lost_sids: list[int]) -> tuple[str, str]:
    """Lay out holder-local vs remote shard files from the encoded
    volume in `src`: local shards + .ecx/.ecj in work/local, surviving
    non-local shards in work/remote, lost shards nowhere."""
    local_d = os.path.join(work, "local")
    remote_d = os.path.join(work, "remote")
    os.makedirs(local_d, exist_ok=True)
    os.makedirs(remote_d, exist_ok=True)
    name = str(VID)
    for ext in (".ecx", ".ecj"):
        if os.path.exists(os.path.join(src, name + ext)):
            shutil.copy(os.path.join(src, name + ext),
                        os.path.join(local_d, name + ext))
    for sid in range(gf.TOTAL_SHARDS):
        if sid in lost_sids:
            continue
        dst = local_d if sid in local_sids else remote_d
        shutil.copy(os.path.join(src, name + pl.to_ext(sid)),
                    os.path.join(dst, name + pl.to_ext(sid)))
    return local_d, remote_d


def needles_on_lost(base: str, contents: dict, lost: list[int],
                    dat_size: int, n: int, rng: random.Random) -> list:
    """Sample n needles whose stripe intervals touch a lost shard —
    the reads that actually pay repair bandwidth."""
    from ..storage.needle_map import SortedFileNeedleMap
    ecx = SortedFileNeedleMap(base + ".ecx")
    touching = []
    for nid, (cookie, data) in contents.items():
        raw = ecx.get_raw(nid)
        if raw is None or raw[1] == t.TOMBSTONE_FILE_SIZE:
            continue
        off, size = raw
        for iv in locate_data(LB, SB, dat_size, off,
                              t.actual_size(size, t.CURRENT_VERSION)):
            sid, _ = iv.to_shard_and_offset(LB, SB)
            if sid in lost:
                touching.append(nid)
                break
    ecx.close()
    rng.shuffle(touching)
    return touching[:n]


def naive_read(ev: EcVolume, counter: RemoteCounter, nid: int,
               cookie: int) -> bytes:
    """The pre-PR all-survivor gather: every interval of the needle is
    served row-by-row; an interval on a lost shard is reconstructed
    from the FIRST k survivors in sid order, locality-blind (each
    remote row its own round trip — the pre-batching shape)."""
    offset, size = ev.find_needle(nid)
    record_len = t.actual_size(size, ev.version)
    parts = []
    for iv in locate_data(ev.large_block, ev.small_block, ev.dat_size,
                          offset, record_len):
        sid, soff = iv.to_shard_and_offset(ev.large_block, ev.small_block)
        f = ev.shards.get(sid)
        if f is not None:
            raw = os.pread(f.fileno(), iv.size, soff)
            parts.append(raw + b"\x00" * (iv.size - len(raw)))
            continue
        raw = counter.fetch(sid, soff, iv.size)
        if raw is not None:   # surviving remote shard: plain fetch
            parts.append(raw)
            continue
        rows, bufs = [], []
        for s in range(gf.TOTAL_SHARDS):
            if s == sid or len(rows) == gf.DATA_SHARDS:
                continue
            fh = ev.shards.get(s)
            if fh is not None:
                raw = os.pread(fh.fileno(), iv.size, soff)
                raw += b"\x00" * (iv.size - len(raw))
            else:
                raw = counter.fetch(s, soff, iv.size)
                if raw is None:
                    continue
            rows.append(s)
            bufs.append(np.frombuffer(raw, np.uint8))
        assert len(rows) == gf.DATA_SHARDS, rows
        coeff = gf.shard_rows([sid], rows)
        out = pl._transform_buffers(ev.encoder(iv.size), coeff, bufs)
        parts.append(host(out[0]).tobytes())
    n = Needle.from_bytes(b"".join(parts), ev.version)
    assert n.cookie == cookie
    return n.data


def _pct(sorted_ms: list[float], p: float) -> float:
    if not sorted_ms:
        return 0.0
    return sorted_ms[min(len(sorted_ms) - 1,
                         int(p / 100.0 * len(sorted_ms)))]


def bench_degraded(src: str, contents: dict, args, report: dict) -> None:
    rng = random.Random(args.seed + 1)
    lost = list(range(args.missing))                 # data shards die
    local = list(range(gf.DATA_SHARDS, gf.TOTAL_SHARDS))  # parity local
    base = os.path.join(src, str(VID))
    dat_size = pl.find_dat_file_size(base)
    nids = needles_on_lost(base, contents, lost, dat_size,
                           args.reads, rng)
    if not nids:
        raise SystemExit("no needles touch the lost shards; grow --size-mb")
    results = {}
    for mode in ("naive", "plan"):
        with tempfile.TemporaryDirectory(dir=src) as work:
            local_d, remote_d = split_layout(src, work, local, lost)
            counter = RemoteCounter(
                remote_d, base,
                [s for s in range(gf.TOTAL_SHARDS)
                 if s not in local and s not in lost],
                args.holders)
            ev = EcVolume(
                local_d, "", VID, large_block=LB, small_block=SB,
                encoder=pl.get_encoder(),
                fetch_remote=counter.fetch,
                fetch_remote_batch=(counter.fetch_batch
                                    if mode == "plan" else None),
                recover_cache=(EcRecoverCache(16 << 20)
                               if mode == "plan" else None),
                holder_peek=(lambda c=counter: dict(c.holder_of))
                if mode == "plan" else None)
            lat_ms: list[float] = []
            repaired = 0
            t0 = time.perf_counter()
            try:
                for nid in nids:
                    cookie, data = contents[nid]
                    t1 = time.perf_counter()
                    if mode == "naive":
                        got = naive_read(ev, counter, nid, cookie)
                    else:
                        got = ev.read_needle(nid, cookie).data
                    lat_ms.append((time.perf_counter() - t1) * 1e3)
                    assert got == data, f"byte mismatch nid={nid} {mode}"
                    repaired += len(data)
            finally:
                ev.close()
            dur = time.perf_counter() - t0
            lat_ms.sort()
            results[mode] = {
                "reads": len(nids),
                "bytes_repaired": repaired,
                "bytes_fetched": counter.bytes_fetched,
                "round_trips": counter.round_trips,
                "intervals_fetched": counter.intervals,
                "max_batch_rows": counter.max_batch_rows,
                "bytes_moved_per_byte_repaired": round(
                    counter.bytes_fetched / max(1, repaired), 3),
                "repair_MBps": round(repaired / (1 << 20) / dur, 2),
                "p50_ms": round(_pct(lat_ms, 50), 3),
                "p99_ms": round(_pct(lat_ms, 99), 3),
            }
    report["degraded"] = {
        "lost_shards": lost, "local_shards": local,
        "holders": args.holders, **{k: v for k, v in results.items()}}
    n, p = results["naive"], results["plan"]
    print(f"degraded reads ({len(nids)} needles, lost={lost}, "
          f"local={local}):")
    for mode, r in results.items():
        print(f"  {mode:6s} bytes-moved/byte-repaired="
              f"{r['bytes_moved_per_byte_repaired']:<6} "
              f"fetched={r['bytes_fetched'] / (1 << 20):.1f}MB "
              f"round-trips={r['round_trips']:<5} "
              f"repair={r['repair_MBps']}MB/s "
              f"p50={r['p50_ms']}ms p99={r['p99_ms']}ms")
    if args.smoke:
        assert p["bytes_fetched"] < n["bytes_fetched"], \
            (p["bytes_fetched"], n["bytes_fetched"])
        assert p["max_batch_rows"] <= gf.DATA_SHARDS, p["max_batch_rows"]
        assert p["round_trips"] < n["round_trips"]
        print("  smoke OK: plan moves strictly fewer bytes over fewer "
              "round trips, fetches <= k rows")


REBUILD_BUF = 128 * 1024   # rebuild window: small enough that a bench
#                            volume holds several per shard, so the
#                            ceil(W/B) dispatch contract is exercised


def bench_rebuild(src: str, args, report: dict) -> None:
    base = os.path.join(src, str(VID))
    lost = [0, 1, gf.DATA_SHARDS, gf.DATA_SHARDS + 1][:max(2, args.missing)]
    originals = {}
    for sid in lost:
        with open(base + pl.to_ext(sid), "rb") as f:
            originals[sid] = f.read()
    shard_size = len(originals[lost[0]])
    n_windows = -(-shard_size // REBUILD_BUF)
    results = {}
    for mode in ("sequential", "batched"):
        for sid in lost:
            if os.path.exists(base + pl.to_ext(sid)):
                os.remove(base + pl.to_ext(sid))
        stats: dict = {}
        rebuilt = pl.rebuild_ec_files(base, encoder=pl.get_encoder(),
                                      sequential=(mode == "sequential"),
                                      buffer_size=REBUILD_BUF,
                                      batch_windows=args.batch,
                                      stats=stats, large_block=LB,
                                      small_block=SB)
        assert sorted(rebuilt) == sorted(lost), (rebuilt, lost)
        for sid in lost:
            with open(base + pl.to_ext(sid), "rb") as f:
                assert f.read() == originals[sid], \
                    f"rebuild {mode} shard {sid} differs"
        results[mode] = {
            "lost": lost,
            "seconds": round(stats["seconds"], 4),
            "bytes_read": stats["bytes_read"],
            "bytes_rebuilt": stats["bytes_rebuilt"],
            "launches": stats["launches"],
            "bytes_moved_per_byte_repaired": round(
                stats["bytes_read"] / stats["bytes_rebuilt"], 3),
            "rebuild_MBps": round(
                stats["bytes_rebuilt"] / (1 << 20) / stats["seconds"], 2),
        }
    speedup = results["sequential"]["seconds"] / \
        max(1e-9, results["batched"]["seconds"])
    report["rebuild"] = {**results, "speedup": round(speedup, 2)}
    print(f"whole-volume rebuild ({len(lost)} lost shards {lost}):")
    for mode, r in results.items():
        print(f"  {mode:10s} {r['seconds']}s "
              f"{r['rebuild_MBps']}MB/s "
              f"read/rebuilt={r['bytes_moved_per_byte_repaired']} "
              f"launches={r['launches']}")
    print(f"  batched speedup: {speedup:.2f}x")
    if args.smoke:
        # the gate is DETERMINISTIC byte accounting (plus the
        # byte-identity check above): batched reads the survivors once,
        # sequential once per lost shard. Wall-clock speedup at smoke
        # sizes is scheduler-noise territory, so it is reported, not
        # asserted — the full-size run documents it in PERF.md.
        assert results["batched"]["bytes_read"] < \
            results["sequential"]["bytes_read"]
        assert results["batched"]["launches"] < \
            results["sequential"]["launches"]
        # the stripe-batch engine's dispatch contract: ceil(W/B)
        # transform dispatches for a W-window volume (vs W per lost
        # shard in the sequential shape), at the engine's EFFECTIVE
        # width (the byte budget may clamp a huge requested --batch)
        from ..ec.batch import clamp_batch_windows
        eff = clamp_batch_windows(args.batch, REBUILD_BUF,
                                  gf.DATA_SHARDS + len(lost))
        want = -(-n_windows // eff)
        assert results["batched"]["launches"] <= want, \
            (results["batched"]["launches"], want, n_windows, eff)
        if speedup <= 1.0:
            print(f"  note: wall-clock speedup {speedup:.2f}x <= 1 at "
                  f"smoke size (noise); byte accounting still proves "
                  f"the batching win")
        print(f"  smoke OK: batched reads survivors once in "
              f"{results['batched']['launches']} dispatches "
              f"(<= ceil({n_windows}/{args.batch})), byte-identical "
              f"rebuilds")


def host(a) -> np.ndarray:
    """A transform's result as host uint8 bytes: a tensor is copied back
    (on the card this waits for the kernel), an array passes through."""
    if hasattr(a, "cpu"):
        return a.cpu().numpy()
    return np.asarray(a, np.uint8)


def backends() -> list:
    """Every encoder backend available on this host, numpy oracle first
    (it is the byte-identity reference for the others), then the port's
    TorchEncoder from get_encoder(), which raises without a card unless
    SWTPU_TORCH_EC_BACKEND=cpu asks for the host."""
    from ..ec.encoder_cpu import CpuEncoder
    out = [("cpu-numpy", CpuEncoder(use_native=False))]
    from ..native import gf256 as _native
    if _native.available():
        out.append(("cpu-native", CpuEncoder(use_native=True)))
    enc = pl.get_encoder()
    out.append(("torch-gpu" if enc.device.type == "cuda" else "torch-cpu",
                enc))
    return out


def bench_bakeoff(args, report: dict) -> None:
    """Backend bake-off over identical (B, 10, L) window blocks:
    encode GB/s + dispatches-per-GB + repair reconstruct row per
    backend, gated on byte-identity against the per-window numpy
    oracle (wall-clock informational, accounting deterministic)."""
    from ..ec import batch as ecb
    from ..ec.encoder_cpu import CpuEncoder

    B = args.batch
    L = (64 if args.smoke else 512) * 1024      # window bytes
    reps = 2 if args.smoke else 5
    rng = np.random.default_rng(args.seed)
    block = rng.integers(0, 256, (B, gf.DATA_SHARDS, L)).astype(np.uint8)
    bytes_in = block.nbytes
    # the oracle IS cpu-numpy by definition — no need to probe every
    # backend just to fetch it
    oracle = CpuEncoder(use_native=False)
    rows_backends = backends()
    # per-window numpy oracle: THE byte-identity gate
    want_parity = np.stack([
        np.stack(oracle.encode(list(block[b]))[gf.DATA_SHARDS:])
        for b in range(B)])
    full = np.concatenate([block, want_parity], axis=1)
    present = [0, 2, 3, 4, 5, 6, 7, 8, 10, 12]
    lost = [1, 9, 11, 13]
    rows = {}
    for name, enc in rows_backends:
        # encode: batched (ONE dispatch per block) vs per-window
        stats: dict = {}
        par = ecb.transform_block(enc, gf.parity_matrix(), block, stats)
        assert np.array_equal(par, want_parity), \
            f"{name}: batched encode differs from numpy oracle"
        t0 = time.perf_counter()
        for _ in range(reps):
            host(enc.transform_batch(gf.parity_matrix(), block))
        dt = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for b in range(B):
            host(enc.transform_batch(
                gf.parity_matrix(), block[b:b + 1]))
        dt_pw = time.perf_counter() - t0
        # verify: per-window verdicts out of one dispatch
        bad = full.copy()
        bad[B // 2, gf.DATA_SHARDS + 1, 7] ^= 0x40
        verdicts = ecb.verify_block(enc, bad)
        assert verdicts == [i != B // 2 for i in range(B)], \
            (name, verdicts)
        assert ecb.verify_block(enc, full) == [True] * B, name
        # reconstruct (repair-bandwidth row): all 4 lost rows of every
        # window from one coefficient dispatch
        t0 = time.perf_counter()
        rec = host(enc.reconstruct_batch(present, lost,
                                         full[:, present, :]))
        dt_rec = time.perf_counter() - t0
        assert np.array_equal(rec, full[:, lost, :]), \
            f"{name}: batched reconstruct differs from numpy oracle"
        rows[name] = {
            "encode_GBps": round(bytes_in / (1 << 30) / dt, 3),
            "encode_perwindow_GBps": round(
                bytes_in / (1 << 30) / dt_pw, 3),
            "dispatches_per_GB_batched": round((1 << 30) / bytes_in, 1),
            "dispatches_per_GB_perwindow": round(
                B * (1 << 30) / bytes_in, 1),
            "repair_GBps": round(
                len(lost) * B * L / (1 << 30) / dt_rec, 3),
            "byte_identical": True,
        }
    report["bakeoff"] = {"batch": B, "window_bytes": L, "rows": rows}
    print(f"backend bake-off (B={B} windows x 10 x {L >> 10}KB, "
          f"{reps} reps; wall-clock informational, byte-identity "
          f"gated):")
    print(f"  {'backend':10s} {'enc GB/s':>9} {'1-win GB/s':>10} "
          f"{'disp/GB B={}'.format(B):>12} {'disp/GB B=1':>12} "
          f"{'repair GB/s':>12}")
    for name, r in rows.items():
        print(f"  {name:10s} {r['encode_GBps']:>9} "
              f"{r['encode_perwindow_GBps']:>10} "
              f"{r['dispatches_per_GB_batched']:>12} "
              f"{r['dispatches_per_GB_perwindow']:>12} "
              f"{r['repair_GBps']:>12}")
    bench_crossover(args, report)
    if args.smoke:
        print("  smoke OK: every backend byte-identical to the "
              "numpy oracle on encode/verify/reconstruct")


def bench_crossover(args, report: dict) -> None:
    """Measure the host-vs-card single-recover crossover that
    `-ec.smallrecover` (default 1 MB) encodes: the smallest interval
    at which sending the recover transform to the card beats the host
    CpuEncoder. Both go through pipeline._transform_buffers, the call an
    EcVolume recover makes (on the card: host staging, K1, the copy
    back). Informational — prints the measured value next to the
    default so the flag stays honest. Under SWTPU_TORCH_EC_BACKEND=cpu
    no card was asked for, and nothing is measured."""
    from ..ec.encoder_cpu import CpuEncoder
    sizes = [1 << s for s in range(16, 20 if args.smoke else 23)]
    card = pl.get_encoder()
    if card.device.type != "cuda":
        report["crossover"] = {"measured": False, "sizes": sizes,
                               "default_bytes": 1 << 20}
        print("  -ec.smallrecover crossover: not measured "
              "(SWTPU_TORCH_EC_BACKEND=cpu asks for no card)")
        return
    cpu = CpuEncoder()
    coeff = gf.cached_shard_rows((0,), tuple(range(1, 11)))
    rng = np.random.default_rng(args.seed + 2)
    rows = {}
    crossover = None
    for size in sizes:
        bufs = list(rng.integers(0, 256, (gf.DATA_SHARDS, size)
                                 ).astype(np.uint8))
        times = {}
        for name, enc in (("cpu", cpu), ("gpu", card)):
            pl._transform_buffers(enc, coeff, bufs)   # warm
            best = min(
                _timed(lambda: pl._transform_buffers(enc, coeff, bufs))
                for _ in range(3))
            times[name] = best
        rows[size] = {k: round(v * 1e3, 4) for k, v in times.items()}
        if crossover is None and times["gpu"] < times["cpu"]:
            crossover = size
    report["crossover"] = {"measured": True, "sizes_ms": rows,
                           "measured_bytes": crossover,
                           "default_bytes": 1 << 20}
    got = f"{crossover} bytes" if crossover else \
        f"none up to {sizes[-1]} bytes (host wins throughout)"
    print(f"  -ec.smallrecover crossover: measured {got} "
          f"(shipped default {1 << 20}); per-size ms {rows}")


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def bench_engine(src: str, args, report: dict) -> None:
    """Deterministic stripe-batch accounting on a REAL volume: the
    three bulk paths at batch 1 vs batch B must be byte-identical
    with <= ceil(W/B) transform dispatches and strictly fewer
    preads (rebuild is covered by bench_rebuild's asserts)."""
    import hashlib

    from ..ec.batch import clamp_batch_windows

    base = os.path.join(src, str(VID))
    out: dict = {}
    # --- encode_volume ---------------------------------------------------
    enc_rows = {}
    sums = {}
    for bw in (1, args.batch):
        stats: dict = {}
        with tempfile.TemporaryDirectory(dir=src) as d:
            nb = os.path.join(d, str(VID))
            shutil.copy(base + ".dat", nb + ".dat")
            pl.encode_volume(nb, encoder=pl.get_encoder(),
                             large_block=LB, small_block=SB,
                             buffer_size=SB, batch_windows=bw,
                             stats=stats)
            h = hashlib.sha256()
            for sid in range(gf.TOTAL_SHARDS):
                with open(nb + pl.to_ext(sid), "rb") as f:
                    h.update(f.read())
            sums[bw] = h.hexdigest()
        enc_rows[bw] = stats
    windows = enc_rows[1]["windows"]
    out["encode"] = enc_rows
    assert sums[1] == sums[args.batch], "batched encode not byte-identical"
    # ceilings computed at the engine's EFFECTIVE width — the byte
    # budget may clamp a huge requested --batch
    eff = clamp_batch_windows(args.batch, SB, gf.TOTAL_SHARDS)
    want = -(-windows // eff)
    assert enc_rows[args.batch]["dispatches"] <= want, \
        (enc_rows[args.batch]["dispatches"], want, eff)
    assert enc_rows[args.batch]["preads"] < enc_rows[1]["preads"]
    # --- verify_parity (the scrub transform) -----------------------------
    window = 128 * 1024
    ev = EcVolume(src, "", VID, large_block=LB, small_block=SB,
                  encoder=pl.get_encoder())
    try:
        # plant one flipped byte in a parity shard so the verdict set
        # is non-trivial, then restore it
        p12 = base + pl.to_ext(12)
        with open(p12, "r+b") as f:
            f.seek(window + 11)
            orig = f.read(1)
            f.seek(window + 11)
            f.write(bytes([orig[0] ^ 0xFF]))
        try:
            reps = {bw: ev.verify_parity(window, batch_windows=bw)
                    for bw in (1, args.batch)}
        finally:
            with open(p12, "r+b") as f:
                f.seek(window + 11)
                f.write(orig)
    finally:
        ev.close()
    out["scrub"] = reps
    r1, rb = reps[1], reps[args.batch]
    assert r1["bad_windows"] == rb["bad_windows"] == [window], \
        (r1["bad_windows"], rb["bad_windows"])
    eff = clamp_batch_windows(args.batch, window, gf.TOTAL_SHARDS)
    want = -(-r1["windows"] // eff)
    assert rb["dispatches"] <= want, (rb["dispatches"], want, eff)
    assert rb["preads"] < r1["preads"]
    report["engine"] = out
    print(f"stripe-batch engine accounting (B={args.batch}):")
    print(f"  encode {windows} windows: dispatches "
          f"{enc_rows[1]['dispatches']} -> "
          f"{enc_rows[args.batch]['dispatches']} "
          f"(<= ceil = {-(-windows // args.batch)}), preads "
          f"{enc_rows[1]['preads']} -> {enc_rows[args.batch]['preads']}")
    print(f"  scrub  {r1['windows']} windows: dispatches "
          f"{r1['dispatches']} -> {rb['dispatches']}, preads "
          f"{r1['preads']} -> {rb['preads']}, same corrupt verdicts "
          f"{rb['bad_windows']}")
    if args.smoke:
        print("  smoke OK: batched encode+scrub byte-identical, "
              "<= ceil(W/B) dispatches, strictly fewer preads")


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size-mb", type=float, default=32.0)
    ap.add_argument("--reads", type=int, default=200)
    ap.add_argument("--missing", type=int, default=2,
                    help="lost shards (1..4)")
    ap.add_argument("--holders", type=int, default=3,
                    help="emulated remote holder count")
    ap.add_argument("--mode", default="all",
                    choices=["all", "degraded", "rebuild", "bakeoff",
                             "engine"])
    ap.add_argument("--batch", type=int, default=8,
                    help="stripe windows per transform dispatch "
                         "(the engine's B)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--json", default="")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes + hard assertions")
    args = ap.parse_args(argv)
    if not 1 <= args.missing <= gf.PARITY_SHARDS:
        raise SystemExit("--missing must be 1..4")
    if args.smoke:
        args.size_mb = min(args.size_mb, 4.0)
        args.reads = min(args.reads, 60)
    rng = random.Random(args.seed)
    report: dict = {"size_mb": args.size_mb, "missing": args.missing,
                    "batch": args.batch}
    if args.mode == "bakeoff":
        bench_bakeoff(args, report)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(report, f, indent=2)
            print(f"report written to {args.json}")
        return 0
    with tempfile.TemporaryDirectory() as src:
        contents = build_volume(src, args.size_mb, rng)
        report["needles"] = len(contents)
        if args.mode in ("all", "degraded"):
            bench_degraded(src, contents, args, report)
        if args.mode in ("all", "engine"):
            bench_engine(src, args, report)
        if args.mode in ("all", "rebuild"):
            bench_rebuild(src, args, report)
        if args.mode == "all":
            bench_bakeoff(args, report)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"report written to {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
