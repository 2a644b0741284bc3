"""The port's EC volume (seaweedfs_tpu_torch/ec/ec_volume.py): the cases
of tests/test_ec_plan.py pointed at the port, then parity with the JAX
package over the same shard files (degraded reads under missing sets of
size 1-4 give equal needle bytes from equal survivor rows; verify_parity
gives equal reports), the host-vs-device recover routing, and the
pipeline's acceptance of the host CpuEncoder.

From tests/test_ec_plan.py: minimal-fetch repair planning: survivor
selection for every missing-set of size 1..4 picks exactly k rows and
prefers local, then cached, then holder-grouped remote rows; the planned
decode is byte-identical to the naive first-k gather; plans are cached
per missing-set and invalidated on shard mount/unmount; a failed batch
gather refreshes the holder map ONCE (never per shard) before the
per-shard fallback; and survivor rows fetched for one lost shard are
reused — not re-moved — when a second lost shard of the same stripe
recovers."""

import itertools
import os
import random
import shutil

import numpy as np
import pytest

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.ec_volume import (EcVolume, EcVolumeError,
                                              select_survivors)
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.chunk_cache import EcRecoverCache

K = gf.DATA_SHARDS
N = gf.TOTAL_SHARDS
LB = 16 * 1024
SB = 1024


# ---------------------------------------------------------------------
# pure selection: every missing-set of size 1..4
# ---------------------------------------------------------------------

def test_every_missing_set_selects_exactly_k_local_first():
    """Exhaustive over all C(14,1..4) missing-sets: the chosen subset
    has exactly k rows, every available local row is used before any
    remote one, and the coefficient schedule exists (any k rows of the
    RS matrix are independent)."""
    for m in range(1, gf.PARITY_SHARDS + 1):
        for missing in itertools.combinations(range(N), m):
            want = missing[0]
            survivors = [s for s in range(N) if s not in missing]
            # deterministic split: half the survivors are local
            local = survivors[::2]
            remote = [s for s in survivors if s not in local]
            rows = select_survivors(want, local, (), [remote])
            assert len(rows) == K
            assert len(set(rows)) == K
            assert want not in rows
            chosen_local = [s for s in rows if s in local]
            assert chosen_local == sorted(local)[:len(chosen_local)]
            # local rows exhausted before any remote row is moved
            assert len(chosen_local) == min(len(local), K)


def test_selection_prefers_cached_over_remote_and_groups_holders():
    # shard 0 lost; 4 local, 2 cached, rest on two holders
    rows = select_survivors(
        0, local=[10, 11, 12, 13], cached=[5, 7],
        remote_groups=[[1, 2, 3], [4, 6, 8, 9]])
    assert rows[:4] == [10, 11, 12, 13]
    assert rows[4:6] == [5, 7]
    # the larger holder group is drained first (fewest round trips)
    assert rows[6:] == [4, 6, 8, 9]


def test_selection_insufficient_survivors_raises():
    with pytest.raises(EcVolumeError):
        select_survivors(0, local=[1, 2, 3], cached=(),
                         remote_groups=[[4, 5, 6]])


def test_selected_rows_decode_byte_identically_to_naive(tmp_path):
    """Property test across random offsets: reconstructing a lost row
    from the PLANNED survivor subset equals reconstructing it from the
    naive first-k-of-sorted-survivors subset equals the true bytes."""
    rng = random.Random(7)
    size = 4096
    shards = [np.frombuffer(rng.randbytes(size), np.uint8)
              for _ in range(K)]
    from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
    enc = CpuEncoder()
    full = enc.encode(shards)
    sets = [frozenset({s}) for s in range(N)]
    all_sets = [frozenset(c) for m in (2, 3, 4)
                for c in itertools.combinations(range(N), m)]
    sets += rng.sample(all_sets, 24)
    for missing in sets:
        survivors = sorted(s for s in range(N) if s not in missing)
        local = survivors[1::3]
        remote = [s for s in survivors if s not in local]
        for want in missing:
            for off in (0, rng.randrange(1, size - 64), size - 64):
                w = rng.randrange(16, 64)
                planned = select_survivors(want, local, (), [remote])
                naive = survivors[:K]
                for rows in (planned, sorted(planned), naive):
                    coeff = gf.cached_shard_rows(
                        (want,), tuple(rows))
                    got = enc._apply(
                        np.asarray(coeff),
                        [full[s][off:off + w] for s in rows])[0]
                    assert bytes(got) == \
                        bytes(full[want][off:off + w]), (missing, want)


# ---------------------------------------------------------------------
# EcVolume integration fixtures
# ---------------------------------------------------------------------

@pytest.fixture()
def ec_dir(tmp_path):
    """A tiny encoded volume: all 14 shard files + .ecx in one dir."""
    d = str(tmp_path / "vol")
    os.makedirs(d)
    v = Volume(d, "", 9)
    rng = random.Random(3)
    contents = {}
    for i in range(1, 61):
        data = rng.randbytes(rng.randint(100, 3000))
        v.write_needle(Needle(cookie=i * 7, id=i, data=data))
        contents[i] = data
    v.close()
    base = os.path.join(d, "9")
    pl.write_ec_files(base, encoder=pl.get_encoder("cpu"),
                      large_block=LB, small_block=SB, buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    return d, base, contents


def _holder_view(ec_dir, tmp_path, local_sids, lost_sids,
                 recover_cache=None, holder_peek=None,
                 fail_batches: int = 0):
    """EcVolume seeing only `local_sids` locally; other surviving
    shards served by counting remote hooks; `lost_sids` are gone
    everywhere. Returns (ev, counters dict)."""
    d, base, _ = ec_dir
    hd = str(tmp_path / "holder")
    os.makedirs(hd, exist_ok=True)
    for ext in (".ecx", ".ecj"):
        if os.path.exists(base + ext):
            shutil.copy(base + ext, os.path.join(hd, "9" + ext))
    for sid in local_sids:
        shutil.copy(base + pl.to_ext(sid),
                    os.path.join(hd, "9" + pl.to_ext(sid)))
    counters = {"batch_calls": 0, "batch_rows": 0, "single": 0,
                "bytes": 0, "refreshes": 0, "fail_left": fail_batches}

    def fetch(sid, off, size):
        if sid in lost_sids or sid in local_sids:
            return None
        counters["single"] += 1
        counters["bytes"] += size
        with open(base + pl.to_ext(sid), "rb") as f:
            f.seek(off)
            raw = f.read(size)
        return raw + b"\x00" * (size - len(raw))

    def fetch_batch(reads):
        counters["batch_calls"] += 1
        if counters["fail_left"] > 0:
            counters["fail_left"] -= 1
            return None
        out = {}
        for sid, off, size in reads:
            if sid in lost_sids:
                continue
            counters["batch_rows"] += 1
            counters["bytes"] += size
            with open(base + pl.to_ext(sid), "rb") as f:
                f.seek(off)
                raw = f.read(size)
            out[sid] = raw + b"\x00" * (size - len(raw))
        return out

    def refresh():
        counters["refreshes"] += 1

    ev = EcVolume(hd, "", 9, large_block=LB, small_block=SB,
                  encoder=pl.get_encoder("cpu"),
                  fetch_remote=fetch, fetch_remote_batch=fetch_batch,
                  recover_cache=recover_cache, holder_peek=holder_peek,
                  refresh_holders=refresh)
    return ev, counters


def test_degraded_read_fetches_at_most_k_rows(ec_dir, tmp_path):
    """Every recover moves exactly the shortfall: with 4 local parity
    rows, at most 6 remote rows per batch, and needles read back
    byte-identically."""
    _, _, contents = ec_dir
    ev, counters = _holder_view(ec_dir, tmp_path,
                                local_sids=[10, 11, 12, 13],
                                lost_sids=[0])
    try:
        for nid, data in contents.items():
            assert ev.read_needle(nid, nid * 7).data == data
    finally:
        ev.close()
    assert counters["batch_calls"] > 0
    # never more than the k - local shortfall per gather
    assert counters["batch_rows"] <= counters["batch_calls"] * (K - 4)
    assert counters["refreshes"] == 0


def test_plan_cached_per_missing_set_and_invalidated(ec_dir, tmp_path):
    ev, _ = _holder_view(ec_dir, tmp_path, local_sids=[10, 11, 12, 13],
                         lost_sids=[0])
    try:
        p1 = ev._repair_plan(0)
        assert ev._repair_plan(0) is p1          # cached
        assert ev._repair_plan(1) is p1          # same missing-set
        ev.invalidate_plans()
        p2 = ev._repair_plan(0)
        assert p2 is not p1
        # shard unmount changes the missing-set => a fresh plan even
        # without an explicit invalidate (keyed on the live set)
        f = ev.shards.pop(13)
        f.close()
        p3 = ev._repair_plan(0)
        assert p3 is not p2 and 13 not in p3.local
    finally:
        ev.close()


def test_store_unmount_invalidates_plans(ec_dir, tmp_path):
    from seaweedfs_tpu_torch.storage.store import Store
    d, base, _ = ec_dir
    # shard files + .ecx only (no .dat): the store mounts vid 9 as EC
    sd = str(tmp_path / "store")
    os.makedirs(sd)
    for sid in range(N):
        shutil.copy(base + pl.to_ext(sid),
                    os.path.join(sd, "9" + pl.to_ext(sid)))
    shutil.copy(base + ".ecx", os.path.join(sd, "9.ecx"))
    store = Store([sd])
    try:
        ev = store.ec_volumes[9]
        ev._repair_plan(0)
        assert ev._plans
        store.unmount_ec_shards(9, [13])
        assert not ev._plans
    finally:
        store.close()


def test_holder_grouping_orders_remote_rows(ec_dir, tmp_path):
    holders = {1: "hA", 2: "hA", 3: "hA", 4: "hB", 5: "hB", 6: "hC",
               7: "hC", 8: "hC", 9: "hC", 0: "hD"}
    ev, _ = _holder_view(ec_dir, tmp_path, local_sids=[10, 11, 12, 13],
                         lost_sids=[], holder_peek=lambda: holders)
    try:
        plan = ev._repair_plan(0)
        assert plan.local == [10, 11, 12, 13]
        # biggest holder group (hC: 6,7,8,9) first, then hA, hB, hD
        assert plan.remote == [6, 7, 8, 9, 1, 2, 3, 4, 5, 0]
    finally:
        ev.close()


def test_failed_batch_gather_refreshes_holder_map_once(ec_dir, tmp_path):
    """THE satellite regression: a failed batch gather triggers ONE
    holder-map refresh and one batch retry — the per-shard fallback
    never replays a stale holder for every shard in the batch."""
    with open(os.path.join(ec_dir[0], "9" + pl.to_ext(0)), "rb") as f:
        truth = f.read(512)
    # first batch fails -> refresh once -> retry batch serves all rows
    ev, counters = _holder_view(ec_dir, tmp_path,
                                local_sids=[10, 11, 12, 13],
                                lost_sids=[0], fail_batches=1)
    try:
        assert ev._recover_interval(0, 0, 512) == truth
        assert counters["refreshes"] == 1
        assert counters["batch_calls"] == 2
        assert counters["single"] == 0   # no per-shard storm
    finally:
        ev.close()
    # BOTH batches fail -> still exactly one refresh, then the
    # per-shard fallback covers the shortfall
    ev, counters = _holder_view(ec_dir, tmp_path / "b",
                                local_sids=[10, 11, 12, 13],
                                lost_sids=[0], fail_batches=2)
    try:
        assert ev._recover_interval(0, 0, 512) == truth
        assert counters["refreshes"] == 1
        assert counters["batch_calls"] == 2
        assert counters["single"] == K - 4
    finally:
        ev.close()


def test_partial_batch_gather_retry_rows_are_admitted(ec_dir, tmp_path):
    """Review regression: the first batch serves only SOME of the
    needed rows (two holders down); the post-refresh retry batch
    serves the rest and its rows must be ADMITTED — with no per-shard
    fetcher wired, recovery must still succeed on batches alone."""
    d, base, _ = ec_dir
    with open(base + pl.to_ext(0), "rb") as f:
        truth = f.read(512)
    hd = str(tmp_path / "holder")
    os.makedirs(hd)
    shutil.copy(base + ".ecx", os.path.join(hd, "9.ecx"))
    for sid in (10, 11, 12, 13):
        shutil.copy(base + pl.to_ext(sid),
                    os.path.join(hd, "9" + pl.to_ext(sid)))
    calls = {"n": 0, "refreshes": 0}

    def fetch_batch(reads):
        calls["n"] += 1
        out = {}
        for i, (sid, off, size) in enumerate(reads):
            if calls["n"] == 1 and i >= len(reads) - 2:
                continue          # two rows' holders are down
            with open(base + pl.to_ext(sid), "rb") as f:
                f.seek(off)
                out[sid] = f.read(size)
        return out

    ev = EcVolume(hd, "", 9, large_block=LB, small_block=SB,
                  encoder=pl.get_encoder("cpu"),
                  fetch_remote=None, fetch_remote_batch=fetch_batch,
                  refresh_holders=lambda: calls.__setitem__(
                      "refreshes", calls["refreshes"] + 1))
    try:
        assert ev._recover_interval(0, 0, 512) == truth
        assert calls["n"] == 2           # partial batch + one retry
        assert calls["refreshes"] == 1
    finally:
        ev.close()


def test_local_shard_unmounted_mid_recover_demoted_to_remote(
        ec_dir, tmp_path):
    """Review regression: a plan may go stale between planning and the
    local-row preads (unmount race). A planned-local row whose fd is
    gone must be demoted to a remote candidate — with exactly k
    survivors alive, dropping it would fail the recover."""
    d, base, _ = ec_dir
    with open(base + pl.to_ext(10), "rb") as f:
        truth = f.read(256)
    local = list(range(10))
    ev, counters = _holder_view(ec_dir, tmp_path,
                                local_sids=local,
                                lost_sids=[11, 12, 13])
    try:
        missing = frozenset({10, 11, 12, 13})
        stale_plan = ev._repair_plan(10)
        assert 5 in stale_plan.local
        f = ev.shards.pop(5)       # raced unmount AFTER planning
        f.close()
        local.remove(5)            # ...because it migrated to a peer
        #                            (the emulated holders now serve it)
        # pin the stale plan under the NEW missing-set key, emulating
        # the in-flight recover that planned before the unmount
        ev._plans[missing | {5}] = stale_plan
        assert ev._recover_interval(10, 0, 256) == truth
        # the demoted row was fetched remotely (batch or fallback),
        # not silently dropped
        assert counters["batch_rows"] + counters["single"] == 1
    finally:
        ev.close()


def test_cached_survivor_rows_not_refetched_for_second_lost_shard(
        ec_dir, tmp_path):
    """Survivor intervals moved for one lost shard are cached; a
    recover of ANOTHER lost shard over the same interval consumes the
    cached rows instead of re-moving them."""
    rc = EcRecoverCache(8 << 20)
    ev, counters = _holder_view(ec_dir, tmp_path,
                                local_sids=[10, 11, 12, 13],
                                lost_sids=[0, 1], recover_cache=rc)
    try:
        off, size = 0, 512
        truth = {}
        with open(os.path.join(ec_dir[0], "9" + pl.to_ext(0)),
                  "rb") as f:
            truth[0] = f.read(size)
        with open(os.path.join(ec_dir[0], "9" + pl.to_ext(1)),
                  "rb") as f:
            truth[1] = f.read(size)
        assert ev._recover_interval(0, off, size) == truth[0]
        moved_first = counters["bytes"]
        assert moved_first == 6 * size     # exactly the k - 4 shortfall
        assert ev._recover_interval(1, off, size) == truth[1]
        # second recover: 4 local + 6 cached survivor rows -> 0 new bytes
        assert counters["bytes"] == moved_first
    finally:
        ev.close()


# ---------------------------------------------------------------------
# parity with the JAX package over the same shard files
# ---------------------------------------------------------------------

class _RowSpy:
    """Stands in for an ec_volume module's `gf`: delegates everything and
    records the (want, rows) of each recover's coefficient matrix."""

    def __init__(self, gf_mod):
        self._gf = gf_mod
        self.calls: list[tuple] = []

    def cached_shard_rows(self, want, rows, *a):
        self.calls.append((tuple(want), tuple(rows)))
        return self._gf.cached_shard_rows(want, rows, *a)

    def __getattr__(self, name):
        return getattr(self._gf, name)


def _ec_modules():
    from seaweedfs_tpu.ec import ec_volume as ref_ecv
    from seaweedfs_tpu_torch.ec import ec_volume as port_ecv
    return ref_ecv, port_ecv


def _open_both(monkeypatch, d, lost):
    """One EcVolume of each package over directory d with `lost` shards
    closed; each package's `gf` is spied on."""
    ref_ecv, port_ecv = _ec_modules()
    out = []
    for mod in (ref_ecv, port_ecv):
        spy = _RowSpy(mod.gf)
        monkeypatch.setattr(mod, "gf", spy)
        ev = mod.EcVolume(d, "", 9, large_block=LB, small_block=SB)
        for sid in lost:
            ev.shards.pop(sid).close()
        out.append((ev, spy))
    return out


def test_degraded_reads_equal_the_jax_package(ec_dir, monkeypatch):
    """For missing sets of size 1-4 (every data-shard quadruple's worst
    case among them), every needle reads byte-equal in both packages,
    and each recover decodes from the same survivor rows."""
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    d, _, contents = ec_dir
    rng = random.Random(17)
    sets = [(0,), (13,), (2, 11), (0, 3, 7, 9), (10, 11, 12, 13),
            tuple(sorted(rng.sample(range(N), 3))),
            tuple(sorted(rng.sample(range(N), 4)))]
    for lost in sets:
        (ref, ref_spy), (port, port_spy) = _open_both(monkeypatch, d, lost)
        try:
            for nid, data in contents.items():
                a = ref.read_needle(nid, nid * 7)
                b = port.read_needle(nid, nid * 7)
                assert a.data == b.data == data, (lost, nid)
                assert (a.cookie, a.checksum) == (b.cookie, b.checksum)
        finally:
            ref.close()
            port.close()
        # needles live on the data shards: only their loss recovers
        assert bool(port_spy.calls) == any(s < K for s in lost), lost
        assert port_spy.calls == ref_spy.calls, lost
        assert all(want[0] in lost for want, _ in port_spy.calls)


@pytest.mark.parametrize("window", [1024, 4096])
def test_verify_parity_reports_equal_the_jax_package(ec_dir, monkeypatch,
                                                     window):
    """verify_parity on the same shard files gives the same report,
    clean and after one flipped byte of a parity shard, with a shard
    missing and without."""
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    d, base, _ = ec_dir
    ref_ecv, port_ecv = _ec_modules()

    def reports(lost):
        out = []
        for mod in (ref_ecv, port_ecv):
            ev = mod.EcVolume(d, "", 9, large_block=LB, small_block=SB)
            for sid in lost:
                ev.shards.pop(sid).close()
            try:
                out.append(ev.verify_parity(window))
            finally:
                ev.close()
        return out

    ref, port = reports(())
    assert ref == port and ref["bad_windows"] == []
    with open(base + pl.to_ext(12), "r+b") as f:
        f.seek(window + 5)
        b = f.read(1)
        f.seek(window + 5)
        f.write(bytes([b[0] ^ 0x40]))
    ref, port = reports(())
    assert ref == port and ref["bad_windows"] == [window]
    ref, port = reports((3,))
    assert ref == port and ref["missing_shards"] == [3]


# ---------------------------------------------------------------------
# host-vs-device recover routing
# ---------------------------------------------------------------------

def test_recover_routing_follows_small_recover_bytes(ec_dir, monkeypatch):
    """Below small_recover_bytes a recover runs on the port's host
    CpuEncoder; at or above it on get_encoder() (here the plain PyTorch
    version, through SWTPU_TORCH_EC_BACKEND=cpu)."""
    from seaweedfs_tpu_torch.ec import ec_volume as ecv
    from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
    from seaweedfs_tpu_torch.ec.encoder_torch import TorchEncoder
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    d, _, contents = ec_dir
    ev = EcVolume(d, "", 9, large_block=LB, small_block=SB,
                  small_recover_bytes=512)
    assert isinstance(ev.encoder(511), CpuEncoder)
    assert isinstance(ev.encoder(512), TorchEncoder)
    assert ev.encoder(512).device.type == "cpu"
    assert isinstance(ev.encoder(), TorchEncoder)
    seen = []
    real = ecv._transform_buffers_async

    def spy(encoder, coeff, buffers):
        seen.append((type(encoder).__name__, len(buffers[0])))
        return real(encoder, coeff, buffers)

    monkeypatch.setattr(ecv, "_transform_buffers_async", spy)
    ev.shards.pop(0).close()
    try:
        for nid, data in contents.items():
            assert ev.read_needle(nid, nid * 7).data == data
    finally:
        ev.close()
    assert {name for name, _ in seen} == {"CpuEncoder", "TorchEncoder"}
    for name, size in seen:
        assert (name == "CpuEncoder") == (size < 512), (name, size)
    # the default threshold is the JAX package's, 1 MiB
    from seaweedfs_tpu.ec.ec_volume import EcVolume as RefEcVolume
    assert EcVolume.SMALL_RECOVER_BYTES == RefEcVolume.SMALL_RECOVER_BYTES \
        == 1 << 20


def test_device_recover_raises_without_cuda(ec_dir, monkeypatch):
    """With no CUDA device and no SWTPU_TORCH_EC_BACKEND, a recover at or
    above the threshold raises instead of running on the host, and so
    does the degraded read that needs it."""
    import torch
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, _, contents = ec_dir
    ev = EcVolume(d, "", 9, large_block=LB, small_block=SB,
                  small_recover_bytes=SB)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            ev.encoder(1 << 20)
        ev.shards.pop(0).close()
        # a needle of more than one small block has a whole-block
        # interval on every shard it crosses: its recover is >= SB
        big = [nid for nid, data in contents.items() if len(data) > 2 * SB]
        assert big
        with pytest.raises(RuntimeError, match="CUDA"):
            for nid in big:
                ev.read_needle(nid, nid * 7)
    finally:
        ev.close()


# ---------------------------------------------------------------------
# the pipeline takes the host CpuEncoder (small recovers)
# ---------------------------------------------------------------------

def test_transform_buffers_takes_the_host_cpu_encoder():
    """_transform_buffers accepts the port's CpuEncoder (EcVolume hands it
    every recover under small_recover_bytes) and gives the JAX package's
    bytes; any other encoder, the JAX package's own CpuEncoder included,
    still raises TypeError as every non-TorchEncoder did before."""
    from seaweedfs_tpu.ec import pipeline as ref_pl
    from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder as RefCpuEncoder
    from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
    rng = np.random.default_rng(29)
    bufs = [rng.integers(0, 256, 3001, dtype=np.uint8) for _ in range(K)]
    rows = [1, 2, 4, 5, 6, 8, 10, 11, 12, 13]
    coeff = gf.shard_rows([0, 3, 7, 9], rows)
    want = ref_pl._transform_buffers(RefCpuEncoder(), coeff, bufs)
    for use_native in (True, False):
        thunk = pl._transform_buffers_async(
            CpuEncoder(use_native=use_native), coeff, bufs)
        got = thunk()
        assert len(got) == 4
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    torch_out = pl._transform_buffers(pl.get_encoder("cpu"), coeff, bufs)
    assert all(np.array_equal(a, b) for a, b in zip(torch_out, want))
    for other in (RefCpuEncoder(), object()):
        with pytest.raises(TypeError, match="TorchEncoder or a CpuEncoder"):
            pl._transform_buffers(other, coeff, bufs)
