"""Spans inside the port's degraded read (seaweedfs_tpu_torch/ec/ec_volume.py,
ec/pipeline.py, ec/encoder_torch.py). With data shards {0, 3, 7, 9}
lost, a traced `EcVolume.read_needle` records the wait for the volume's
lock (`ec.lock_wait`), each intact interval's pread (`ec.pread`), each
recover's survivor reads (`ec.gather`, with their local, cached and
fetched counts) and the recover itself with the path its transform took
(`ec.recover`, `path` "host" or "card"), all under the request's root.
A lock held by another thread shows as a wait at least as long; an
untraced read records nothing; on the card a recover also records its
staging (`ec.stage`), the one native call that enqueues its chain of
copies and kernels (`ec.h2d`) and the wait for the card (`ec.wait`).
Every recover names the pieces its transform was enqueued in (`pieces`).
The bytes served are the bytes written in every case."""

import os
import random
import threading
import time

import pytest

from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.locate import locate_data
from seaweedfs_tpu_torch.ops.gf256_cuda import piece_bounds
from seaweedfs_tpu_torch.storage import types as t
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import tracing

LB = 16 * 1024
SB = 1024
LOST = (0, 3, 7, 9)
SMALL_RECOVER = 512


@pytest.fixture()
def lost_dir(tmp_path):
    """An encoded volume of 60 needles of 100-3000 bytes, with the shard
    files of LOST removed. Returns (dir, {needle id: bytes})."""
    d = str(tmp_path / "vol")
    os.makedirs(d)
    v = Volume(d, "", 9)
    rng = random.Random(21)
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
    for sid in LOST:
        os.remove(base + pl.to_ext(sid))
    return d, contents


@pytest.fixture()
def ring(monkeypatch):
    """The port's span ring, empty, sampling every root."""
    monkeypatch.setattr(tracing, "_sample", 1.0)
    tracing.reset()
    yield
    tracing.reset()


def open_volume(d):
    return EcVolume(d, "", 9, large_block=LB, small_block=SB,
                    small_recover_bytes=SMALL_RECOVER)


def traced_reads(ev, contents):
    """Every needle read under a root of its own; returns the spans of
    each read, by trace id, after checking its bytes."""
    for nid, data in contents.items():
        with tracing.start_root("test", "get"):
            assert ev.read_needle(nid, nid * 7).data == data
    by_trace = {}
    for g in tracing.traces_dict(recent=1000, slowest=0)["traces"]:
        by_trace[g["trace_id"]] = g["spans"]
    assert len(by_trace) == len(contents)
    return by_trace


def under_root(spans):
    """Every span's parents lead to the one root."""
    by_id = {s["span"]: s for s in spans}
    roots = [s for s in spans if s["tier"] == "test"]
    assert len(roots) == 1
    for s in spans:
        hops = 0
        while s is not roots[0]:
            s = by_id[s["parent"]]
            hops += 1
            assert hops < len(spans)


def ops_of(spans):
    return [s["op"] for s in spans if s["tier"] == "ec"]


def test_traced_degraded_read_records_its_spans(lost_dir, ring,
                                                monkeypatch):
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")
    d, contents = lost_dir
    ev = open_volume(d)
    try:
        by_trace = traced_reads(ev, contents)
    finally:
        ev.close()
    both = 0
    for spans in by_trace.values():
        under_root(spans)
        ops = ops_of(spans)
        assert ops.count("lock_wait") == 1
        for s in spans:
            if s["op"] == "recover":
                # the host CpuEncoder under SMALL_RECOVER, else the plain
                # version of the card's kernel on the CPU: both the host
                assert s["attrs"]["path"] == "host"
                kids = [c for c in spans if c["parent"] == s["span"]]
                assert [c["op"] for c in kids] == ["gather"]
                g = kids[0]["attrs"]
                assert (g["local"], g["cached"], g["fetched"]) == (10, 0, 0)
            if s["op"] in ("pread", "lock_wait"):
                assert s["parent"] == next(
                    r["span"] for r in spans if r["tier"] == "test")
            # no card, so none of the card's spans
            assert s["op"] not in ("stage", "h2d", "d2h", "wait")
        if "pread" in ops and "recover" in ops:
            both += 1
    assert both, "no needle spans an intact and a lost interval"


def test_recover_spans_name_the_rows_they_decode(lost_dir, ring,
                                                 monkeypatch):
    """Each `ec.recover` span of a read is one recover of the lost
    intervals that share a shard offset and size, in first-seen order:
    `want` names their shards, `rows` counts them, and the span's bytes
    are rows x size."""
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")
    d, contents = lost_dir
    ev = open_volume(d)
    try:
        by_trace = traced_reads(ev, contents)
        want_of = {}
        for nid in contents:
            off, size = ev.find_needle(nid)
            groups = {}
            for iv in locate_data(LB, SB, ev.dat_size, off,
                                  t.actual_size(size, t.CURRENT_VERSION)):
                sid, soff = iv.to_shard_and_offset(LB, SB)
                if sid in LOST:
                    groups.setdefault((soff, iv.size), []).append(sid)
            want_of[nid] = [(sids, len(sids), len(sids) * n)
                            for (_, n), sids in groups.items()]
    finally:
        ev.close()
    got = sorted([(s["attrs"]["want"], s["attrs"]["rows"], s["bytes"])
                  for s in spans if s["op"] == "recover"]
                 for spans in by_trace.values())
    assert got == sorted(want_of.values())
    assert sum(len(r) for r in got) > 0


def test_host_recover_spans_name_one_piece(lost_dir, ring, monkeypatch):
    """Off the card every recover's transform is one piece: the
    `ec.recover` span says so in `pieces`."""
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")
    d, contents = lost_dir
    ev = open_volume(d)
    try:
        by_trace = traced_reads(ev, contents)
    finally:
        ev.close()
    pieces = [s["attrs"]["pieces"] for spans in by_trace.values()
              for s in spans if s["op"] == "recover"]
    assert pieces and set(pieces) == {1}


def test_a_held_lock_shows_as_its_wait(lost_dir, ring, monkeypatch):
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")
    d, contents = lost_dir
    ev = open_volume(d)
    hold_s = 0.2
    held = threading.Event()

    def holder():
        with ev._lock:
            held.set()
            # sleep only once the reader is waiting inside its span
            deadline = time.monotonic() + 30
            while not any(r["op"] == "lock_wait" for r in
                          tracing.requests_dict()["requests"]):
                assert time.monotonic() < deadline
                time.sleep(0.001)
            time.sleep(hold_s)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    try:
        assert held.wait(30)
        nid = max(contents, key=lambda n: len(contents[n]))
        with tracing.start_root("test", "get"):
            assert ev.read_needle(nid, nid * 7).data == contents[nid]
        t.join(30)
        assert not t.is_alive()
    finally:
        ev.close()
    waits = [s for g in tracing.traces_dict(recent=10, slowest=0)["traces"]
             for s in g["spans"] if s["op"] == "lock_wait"]
    assert len(waits) == 1
    assert waits[0]["dur_ms"] >= hold_s * 1e3


def test_untraced_read_records_nothing(lost_dir, ring, monkeypatch):
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")
    d, contents = lost_dir
    ev = open_volume(d)
    try:
        for nid, data in contents.items():
            assert ev.read_needle(nid, nid * 7).data == data
    finally:
        ev.close()
    assert tracing.traces_dict(recent=1000, slowest=0)["spans"] == 0
    assert tracing.requests_dict()["inflight"] == 0


@pytest.mark.gpu
def test_card_recover_records_staging_copies_and_wait(lost_dir, ring,
                                                      monkeypatch):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's spans are on its path")
    monkeypatch.delenv(pl.BACKEND_ENV, raising=False)
    d, contents = lost_dir
    ev = open_volume(d)
    try:
        by_trace = traced_reads(ev, contents)
    finally:
        ev.close()
    paths = set()
    for spans in by_trace.values():
        under_root(spans)
        for s in spans:
            if s["op"] != "recover":
                continue
            paths.add(s["attrs"]["path"])
            kids = [c["op"] for c in spans if c["parent"] == s["span"]]
            if s["attrs"]["path"] == "card":
                assert s["bytes"] >= SMALL_RECOVER
                # the survivors copied once into the pinned piece-major
                # input, the pinned output; one enqueue of the whole
                # chain; one wait
                assert sorted(kids) == sorted(
                    ["gather"] + ["stage"] * 2 + ["h2d", "wait"])
                assert s["attrs"]["pieces"] == len(
                    piece_bounds(s["bytes"] // s["attrs"]["rows"])) - 1
            else:
                assert s["bytes"] < SMALL_RECOVER
                assert kids == ["gather"]
    assert paths == {"card", "host"}
