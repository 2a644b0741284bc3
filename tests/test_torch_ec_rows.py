"""Row-grouped degraded reads in the port (seaweedfs_tpu_torch/ec/ec_volume.py).

One `EcVolume.read_needle` decodes all of its lost intervals that share a
stripe row, the same shard offset and the same length, in one recover:
one survivor gather, one transform of r rows. For lost sets {4},
{0, 3, 7, 9} and {0, 1, 2, 3}, over needles that lie in one stripe row
and across two, each read gives the written bytes and the JAX package's
bytes on the same shard files, makes one transform per distinct (shard
offset, size) of its recovered intervals (one per lost interval where a
single shard is lost), and leaves every decoded interval in the recover
cache under its own key. An interval already cached, or served by
`fetch_remote`, is not decoded again."""

import os

import numpy as np
import pytest

from seaweedfs_tpu_torch.ec import ec_volume as ecv
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.locate import locate_data
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util.chunk_cache import EcRecoverCache

N = gf.TOTAL_SHARDS
LB = 16 * 1024
SB = 1024
VID = 9
# needle data sizes: under a block, within one stripe row over several
# blocks, and across two and three rows; 150 KiB in all, so the volume
# lies wholly in the small-block layout
SIZES = (300, 3500, 9000, 12500, 4100, 21000, 700, 15500, 6200, 26000,
         2500, 18000, 8000, 11000)
LOST_SETS = [(4,), (0, 3, 7, 9), (0, 1, 2, 3)]


@pytest.fixture(autouse=True)
def _cpu_backend(monkeypatch):
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """The encoded volume's directory, {needle id: data} and every
    shard's bytes."""
    d = str(tmp_path_factory.mktemp("rows"))
    v = Volume(d, "", VID)
    rng = np.random.default_rng(22)
    contents = {}
    for i, n in enumerate(SIZES, 1):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        v.write_needle(Needle(cookie=i * 11, id=i, data=data))
        contents[i] = data
    v.close()
    base = os.path.join(d, str(VID))
    pl.write_ec_files(base, encoder=pl.get_encoder("cpu"), large_block=LB,
                      small_block=SB, buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    truth = {}
    for sid in range(N):
        with open(base + pl.to_ext(sid), "rb") as f:
            truth[sid] = f.read()
    assert len(truth[0]) * gf.DATA_SHARDS <= gf.DATA_SHARDS * LB
    return d, contents, truth


def open_port(d, lost, rc=None):
    ev = EcVolume(d, "", VID, large_block=LB, small_block=SB,
                  recover_cache=rc, small_recover_bytes=SB // 2)
    for sid in lost:
        ev.shards.pop(sid).close()
    return ev


def open_ref(d, lost):
    from seaweedfs_tpu.ec.ec_volume import EcVolume as RefEcVolume
    ev = RefEcVolume(d, "", VID, large_block=LB, small_block=SB)
    for sid in lost:
        ev.shards.pop(sid).close()
    return ev


def lost_intervals(ev, nid, lost):
    """(sid, shard offset, size) of needle nid's intervals on lost
    shards, in interval order."""
    off, size = ev.find_needle(nid)
    out = []
    for iv in locate_data(LB, SB, ev.dat_size, off,
                          t.actual_size(size, t.CURRENT_VERSION)):
        sid, soff = iv.to_shard_and_offset(LB, SB)
        if sid in lost:
            out.append((sid, soff, iv.size))
    return out


def groups_of(ivs):
    """{(shard offset, size): [sids]}, in first-seen order."""
    out = {}
    for sid, soff, size in ivs:
        out.setdefault((soff, size), []).append(sid)
    return out


class Spy:
    """Records each transform's (rows, length) and each recover's
    (want_sids, offset, size) of one EcVolume."""

    def __init__(self, monkeypatch, ev):
        self.transforms, self.recovers = [], []
        real_transform = ecv._transform_buffers_async
        real_recover = ev._recover_rows_src

        def transform(encoder, coeff, buffers):
            self.transforms.append((coeff.shape[0], len(buffers[0])))
            return real_transform(encoder, coeff, buffers)

        def recover(want_sids, offset, size):
            self.recovers.append((tuple(want_sids), offset, size))
            return real_recover(want_sids, offset, size)

        monkeypatch.setattr(ecv, "_transform_buffers_async", transform)
        monkeypatch.setattr(ev, "_recover_rows_src", recover)

    def clear(self):
        self.transforms.clear()
        self.recovers.clear()


@pytest.mark.parametrize("lost", LOST_SETS, ids=lambda s: "-".join(
    map(str, s)))
def test_grouped_reads_decode_each_row_once(encoded, monkeypatch, lost):
    d, contents, truth = encoded
    rc = EcRecoverCache(8 << 20)
    ev = open_port(d, lost, rc)
    ref = open_ref(d, lost)
    spy = Spy(monkeypatch, ev)
    grouped = two_rows = 0
    try:
        for nid, data in contents.items():
            ivs = lost_intervals(ev, nid, lost)
            groups = groups_of(ivs)
            spy.clear()
            n = ev.read_needle(nid, nid * 11)
            assert n.data == data == ref.read_needle(nid, nid * 11).data
            # one transform a distinct (shard offset, size), r rows each
            assert spy.recovers == [(tuple(sids), soff, size)
                                    for (soff, size), sids in groups.items()]
            assert spy.transforms == [(len(sids), size)
                                      for (_, size), sids in groups.items()]
            if len(lost) == 1:
                assert len(spy.transforms) == len(ivs)
            grouped += any(len(sids) > 1 for sids in groups.values())
            two_rows += len({soff // SB for _, soff, _ in ivs}) > 1
            # every decoded interval is cached under its own key
            for sid, soff, size in ivs:
                assert rc.get((VID, sid, soff, size)) == \
                    truth[sid][soff:soff + size]
    finally:
        ev.close()
        ref.close()
    assert two_rows > 0
    assert (grouped > 0) == (len(lost) > 1)


def row_group_needle(ev, contents, lost, rows=3):
    """A needle with a group of at least `rows` lost intervals, and that
    group's (shard offset, size) and sids."""
    for nid in contents:
        for key, sids in groups_of(lost_intervals(ev, nid, lost)).items():
            if len(sids) >= rows:
                return nid, key, sids
    raise AssertionError(f"no needle has {rows} lost intervals in a row")


@pytest.mark.parametrize("hot_at", [0, 1])
def test_a_cached_interval_leaves_its_group(encoded, monkeypatch, hot_at):
    """The group's first or second interval in the cache: the others
    still decode in one recover, and the read looks each lost interval
    up in the cache once."""
    d, contents, truth = encoded
    lost = (0, 1, 2, 3)
    rc = EcRecoverCache(8 << 20)
    ev = open_port(d, lost, rc)
    spy = Spy(monkeypatch, ev)
    try:
        nid, (soff, size), sids = row_group_needle(ev, contents, lost)
        hot = sids[hot_at]
        rc.put((VID, hot, soff, size), truth[hot][soff:soff + size])
        c = rc.counters
        before = c.hits + c.misses
        assert ev.read_needle(nid, nid * 11).data == contents[nid]
        assert c.hits + c.misses - before == len(lost_intervals(ev, nid,
                                                                lost))
        mine = [r for r in spy.recovers if r[1:] == (soff, size)]
        assert mine == [(tuple(s for s in sids if s != hot), soff, size)]
    finally:
        ev.close()


def test_an_interval_fetch_remote_serves_is_not_recovered(encoded,
                                                          monkeypatch):
    d, contents, truth = encoded
    lost = (0, 1, 2, 3)
    ev = open_port(d, lost)
    spy = Spy(monkeypatch, ev)
    served = []
    try:
        nid, (soff, size), sids = row_group_needle(ev, contents, lost)
        peer = sids[0]

        def fetch_remote(sid, offset, length):
            if sid != peer:
                return None
            served.append((sid, offset, length))
            return truth[sid][offset:offset + length]

        ev.fetch_remote = fetch_remote
        assert ev.read_needle(nid, nid * 11).data == contents[nid]
        assert (peer, soff, size) in served
        assert all(peer not in want for want, _, _ in spy.recovers)
        mine = [r for r in spy.recovers if r[1:] == (soff, size)]
        assert mine == [(tuple(sids[1:]), soff, size)]
    finally:
        ev.close()


def test_recover_counters_count_rows_and_recovers(encoded, monkeypatch):
    """SeaweedFS_ec_recovers_total moves by one a recover and
    SeaweedFS_ec_recover_rows_total by the rows it decoded, under the
    path the transform took (here the host's)."""
    from seaweedfs_tpu_torch.stats import metrics
    if not metrics.HAVE_PROMETHEUS:
        pytest.skip("prometheus_client is not installed")
    d, contents, _ = encoded
    lost = (0, 1, 2, 3)
    ev = open_port(d, lost)
    spy = Spy(monkeypatch, ev)

    def counts():
        get = metrics.REGISTRY.get_sample_value
        return {(name, p): get(name, {"path": p}) or 0.0
                for name in ("SeaweedFS_ec_recovers_total",
                             "SeaweedFS_ec_recover_rows_total")
                for p in ("host", "card")}

    try:
        nid, _, _ = row_group_needle(ev, contents, lost, rows=4)
        before = counts()
        assert ev.read_needle(nid, nid * 11).data == contents[nid]
        after = counts()
    finally:
        ev.close()
    moved = {k: after[k] - before[k] for k in after}
    assert moved == {
        ("SeaweedFS_ec_recovers_total", "host"): len(spy.recovers),
        ("SeaweedFS_ec_recover_rows_total", "host"): sum(
            len(w) for w, _, _ in spy.recovers),
        ("SeaweedFS_ec_recovers_total", "card"): 0.0,
        ("SeaweedFS_ec_recover_rows_total", "card"): 0.0}
    assert max(len(w) for w, _, _ in spy.recovers) == 4


def test_recover_pieces_counter_counts_one_a_host_recover(encoded,
                                                        monkeypatch):
    """SeaweedFS_ec_recover_pieces_total moves by the pieces a recover's
    transform was enqueued in: one a recover off the card."""
    from seaweedfs_tpu_torch.stats import metrics
    if not metrics.HAVE_PROMETHEUS:
        pytest.skip("prometheus_client is not installed")
    d, contents, _ = encoded
    lost = (0, 3, 7, 9)
    ev = open_port(d, lost)
    spy = Spy(monkeypatch, ev)

    def pieces():
        return {p: metrics.REGISTRY.get_sample_value(
            "SeaweedFS_ec_recover_pieces_total", {"path": p}) or 0.0
            for p in ("host", "card")}

    try:
        nid, _, _ = row_group_needle(ev, contents, lost, rows=4)
        before = pieces()
        assert ev.read_needle(nid, nid * 11).data == contents[nid]
        after = pieces()
    finally:
        ev.close()
    assert spy.recovers
    assert {p: after[p] - before[p] for p in after} == {
        "host": float(len(spy.recovers)), "card": 0.0}


@pytest.mark.gpu
def test_an_8_mib_part_launches_once_a_row_on_the_card(tmp_path,
                                                       monkeypatch):
    """With data shards {0, 3, 7, 9} lost and the default 1 MiB blocks, a
    GET of an 8 MiB part makes one card recover a stripe row, not one a
    lost interval, each a chain that launches K1 once a piece of its
    plan; the card copies out the recovered bytes and no more, and the
    part reads back whole."""
    import json

    import torch
    from torch.profiler import ProfilerActivity, profile

    from seaweedfs_tpu_torch.ops import gf256_cuda
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.delenv(pl.BACKEND_ENV, raising=False)
    mib = 1 << 20
    lost = (0, 3, 7, 9)
    d = str(tmp_path)
    v = Volume(d, "", VID)
    rng = np.random.default_rng(8)
    parts = {}
    for nid, n in ((1, 300 << 10), (2, 8 * mib), (3, 8 * mib)):
        parts[nid] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        v.write_needle(Needle(cookie=nid, id=nid, data=parts[nid]))
    v.close()
    base = os.path.join(d, str(VID))
    pl.write_ec_files(base, encoder=pl.get_encoder())
    pl.write_sorted_file_from_idx(base)
    ev = EcVolume(d, "", VID)
    for sid in lost:
        ev.shards.pop(sid).close()
    try:
        for nid in (2, 3):
            off, size = ev.find_needle(nid)
            ivs = []
            for iv in locate_data(ev.large_block, ev.small_block,
                                  ev.dat_size, off,
                                  t.actual_size(size, t.CURRENT_VERSION)):
                sid, soff = iv.to_shard_and_offset(ev.large_block,
                                                   ev.small_block)
                if sid in lost:
                    ivs.append((sid, soff, iv.size))
            card = {k: sids for k, sids in groups_of(ivs).items()
                    if k[1] >= ev.small_recover_bytes}
            card_ivs = sum(len(sids) for sids in card.values())
            assert len(card) < card_ivs
            torch.cuda.synchronize()
            before = gf256_cuda.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                n = ev.read_needle(nid, nid)
                torch.cuda.synchronize()
            # one chain a stripe row, one K1 launch a piece of it
            assert gf256_cuda.launches - before == sum(
                len(gf256_cuda.piece_bounds(size)) - 1
                for _, size in card)
            assert n.data == parts[nid]
            path = str(tmp_path / f"trace{nid}.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", ())
            out = sum(int((e.get("args") or {}).get("bytes", 0) or 0)
                      for e in events
                      if e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                      and "DtoH" in e.get("name", ""))
            assert out == sum(size * len(sids)
                              for (_, size), sids in card.items())
    finally:
        ev.close()
