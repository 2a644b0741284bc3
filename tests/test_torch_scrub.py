"""The port's paced background parity scrubber
(seaweedfs_tpu_torch/ec/scrub.py): the cases of tests/test_scrub.py that
start no cluster, pointed at the port. It detects real on-disk bit-rot
and failpoint-injected corruption, paces itself under its token-bucket
byte budget and pauses behind hot foreground traffic. Failpoints are
armed on the port's own registry (seaweedfs_tpu_torch.util.failpoints),
which the JAX package's registry does not reach; the last case shows
that. The last cases drive /debug/scrub on a port volume server under
the reference master (test_torch_cluster_util), and hold a forced cycle
to localizing one flipped parity byte to its shard: scrub.py catches a
failure to localize and reports the window unlocalized, so only this
check turns such a failure into a failed test."""

import asyncio
import os
import random
import shutil

import pytest

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.scrub import ForegroundLoad, Scrubber, TokenBucket
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.store import Store
from seaweedfs_tpu_torch.storage.volume import Volume
from seaweedfs_tpu_torch.util import failpoints as fp
from test_torch_cluster_util import Cluster



def run(coro):
    return asyncio.run(coro)

LB = 16 * 1024
SB = 1024
WINDOW = 8 * 1024


@pytest.fixture(autouse=True)
def _clean_registry():
    fp.reset()
    yield
    fp.reset()


@pytest.fixture()
def ec_store(tmp_path):
    """A Store with one fully-local mounted EC volume (vid 3)."""
    build = str(tmp_path / "build")
    os.makedirs(build)
    v = Volume(build, "", 3)
    rng = random.Random(5)
    for i in range(1, 41):
        v.write_needle(Needle(cookie=i, id=i,
                              data=rng.randbytes(rng.randint(500, 4000))))
    v.close()
    base = os.path.join(build, "3")
    pl.write_ec_files(base, encoder=pl.get_encoder("cpu"),
                      large_block=LB, small_block=SB, buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    d = str(tmp_path / "store")
    os.makedirs(d)
    for sid in range(gf.TOTAL_SHARDS):
        shutil.copy(base + pl.to_ext(sid),
                    os.path.join(d, "3" + pl.to_ext(sid)))
    shutil.copy(base + ".ecx", os.path.join(d, "3.ecx"))
    store = Store([d], ec_large_block=LB, ec_small_block=SB)
    assert 3 in store.ec_volumes
    yield d, store
    store.close()


# ---------------------------------------------------------------------
# pacing primitives
# ---------------------------------------------------------------------

def test_token_bucket_paces_to_budget():
    clock = {"t": 0.0}
    slept = []

    async def fake_sleep(s):
        slept.append(s)
        clock["t"] += s

    bucket = TokenBucket(1000.0, burst_bytes=1000.0,
                         now=lambda: clock["t"], sleep=fake_sleep)

    async def go():
        await bucket.consume(500)      # burst covers it
        assert slept == []
        await bucket.consume(1000)     # 500 left -> wait 0.5s
        assert slept == [pytest.approx(0.5)]
        await bucket.consume(2500)     # oversized: waits, never wedges
        assert len(slept) == 2
    run(go())


def test_token_bucket_unpaced_when_rate_zero():
    async def go():
        bucket = TokenBucket(0.0, sleep=None)  # sleep never called
        assert await bucket.consume(1 << 30) == 0.0
    run(go())


def test_foreground_load_windows():
    load = ForegroundLoad()
    assert not load.hot(50.0, 2.0)
    load.note(0.002)
    assert not load.hot(50.0, 2.0)     # 2ms < 50ms threshold
    load.note(0.5)
    assert load.hot(50.0, 2.0)
    assert load.hot(0.0, 2.0) is False  # 0 disables pausing
    count, worst_ms = load.snapshot(2.0)
    assert count == 2 and worst_ms == pytest.approx(500.0)
    # a flood of fast requests must NOT evict the recent slow outlier
    # (per-second max buckets, not a request-count-bounded ring)
    for _ in range(5000):
        load.note(0.001)
    assert load.hot(50.0, 2.0)
    count, worst_ms = load.snapshot(2.0)
    assert count == 5002 and worst_ms == pytest.approx(500.0)


# ---------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------

def test_clean_volume_scrubs_clean(ec_store):
    _, store = ec_store
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        assert report["volumes"] == 1
        assert report["corrupt"] == 0
        assert report["windows"] > 1
        assert report["bytes"] > 0
        assert s.status()["corrupt_windows"] == 0
    run(go())


def test_scrub_detects_on_disk_bit_rot_in_every_planted_window(ec_store):
    d, store = ec_store
    ssize = store.ec_volumes[3].shard_size
    # flip one byte in window 1 of a parity shard and one byte in the
    # LAST window of a data shard — silent corruption a foreground
    # needle read (data shards, CRC-checked) may never visit
    planted = [(pl.to_ext(12), WINDOW + 17), (pl.to_ext(4), ssize - 9)]
    for ext, off in planted:
        p = os.path.join(d, "3" + ext)
        with open(p, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        want = sorted({(off // WINDOW) * WINDOW for _, off in planted})
        found = sorted(c["offset"] for c in s.corruptions)
        assert found == want, (found, want)
        assert report["corrupt"] == len(want)
        assert s.status()["corrupt_windows"] == len(want)
    run(go())


def test_reported_windows_schema_and_localization(ec_store):
    """Satellite: /debug/scrub corruption reports carry a
    machine-readable `reported_windows` list — (vid, window index,
    offset, size, LOCALIZED shard ids) — so the autopilot observer
    consumes structure instead of parsing prose. Rot planted in a
    parity shard AND a data shard must both be pinned to the right
    shard id by the hypothesis test."""
    d, store = ec_store
    ssize = store.ec_volumes[3].shard_size
    # window 0: parity-shard rot; a DIFFERENT window: data-shard rot
    planted = {(pl.to_ext(12), 17): 12,
               (pl.to_ext(4), ssize - 9): 4}
    assert (ssize - 9) // WINDOW != 0
    for (ext, off), _sid in planted.items():
        p = os.path.join(d, "3" + ext)
        with open(p, "r+b") as f:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        rows = report["corrupt_windows"]
        assert len(rows) == 2, rows
        # the same structured rows ride the cumulative status ring
        assert s.status()["reported_windows"] == rows
        for row in rows:
            for key in ("volume", "window", "offset", "size",
                        "shards", "wall"):
                assert key in row, (key, row)
            assert row["offset"] == row["window"] * WINDOW
        by_window = {r["window"]: r["shards"] for r in rows}
        assert by_window[0] == [12]                     # parity rot
        assert by_window[(ssize - 9) // WINDOW] == [4]  # data rot
    run(go())


def test_multi_shard_rot_in_one_window_stays_unlocalized(ec_store):
    """Two shards rotten in the SAME window: no single-corruption
    hypothesis holds, so `shards` must be [] — the autopilot defers
    instead of guessing which copy to destroy."""
    d, store = ec_store
    for ext in (pl.to_ext(12), pl.to_ext(4)):
        p = os.path.join(d, "3" + ext)
        with open(p, "r+b") as f:
            f.seek(40)
            b = f.read(1)
            f.seek(40)
            f.write(bytes([b[0] ^ 0xFF]))
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        rows = [r for r in report["corrupt_windows"]
                if r["window"] == 0]
        assert rows and rows[0]["shards"] == [], rows
    run(go())


def test_scrub_detects_failpoint_injected_flip(ec_store):
    """scrub.read armed with `flip` corrupts scrub-side reads only:
    the scrubber must flag the window; a foreground needle read sees
    clean bytes."""
    _, store = ec_store
    fp.arm("scrub.read", "flip:3")    # 3 row reads -> all in window 0
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        assert report["corrupt"] == 1
        assert s.corruptions[0]["offset"] == 0
        # spent: second cycle is clean again
        report = await s.run_cycle()
        assert report["corrupt"] == 0
        n = store.read_needle(3, 7, 7)    # foreground read unaffected
        assert n.data
    run(go())


def test_flip_failpoint_corrupts_payload_only():
    fp.arm("x", "flip=4:1")
    out = fp.corrupt("x", b"\x00" * 8)
    assert out == b"\xff" * 4 + b"\x00" * 4
    assert fp.corrupt("x", b"\x00" * 8) == b"\x00" * 8  # spent
    # non-payload sites treat flip as a consumed no-op
    fp.arm("y", "flip:1")
    fp.sync_fail("y")
    assert not fp.pending("y")
    with pytest.raises(ValueError):
        fp.parse_spec("z", "flip=0")


def test_scrub_never_reports_clean_from_reconstructed_rows(ec_store):
    """Review regression: a holder dying MID-CYCLE (after the
    missing-shards probe passed) must not let the scrubber verify a
    window against a row it reconstructed itself — parity recomputed
    from derived rows matches trivially. The volume lands in the
    cycle's errors, never in its clean windows."""
    d, store = ec_store
    ev = store.ec_volumes[3]
    f = ev.shards.pop(6)
    f.close()
    # the holder still answers the cycle-start 1-byte probe, then
    # stops serving window reads (restart mid-cycle)
    ev.fetch_remote = lambda sid, off, size: \
        b"\x00" if size == 1 else None
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        assert report["windows"] == 0          # no false evidence
        assert report["corrupt"] == 0
        assert [e["volume"] for e in report["errors"]] == [3]
        assert "unreachable mid-scrub" in report["errors"][0]["error"]
    run(go())


def test_scrub_only_lowest_shard_holder_owns_the_volume(ec_store):
    """With shards spread across holders, exactly ONE server scrubs a
    volume (the holder of shard 0) — otherwise every holder would move
    the same stripe bytes over the network once per cycle."""
    d, store = ec_store
    ev = store.ec_volumes[3]
    f = ev.shards.pop(0)
    f.close()
    path = os.path.join(d, "3" + pl.to_ext(0))

    def remote(sid, off, size):     # shard 0 alive on a peer
        if sid != 0:
            return None
        with open(path, "rb") as fh:
            fh.seek(off)
            return fh.read(size)

    ev.fetch_remote = remote
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        assert report["volumes"] == 0
        assert report["windows"] == 0
        assert report["skipped"] == [{"volume": 3,
                                      "reason": "not-owner"}]
    run(go())


def test_scrub_skips_volumes_with_missing_shards(ec_store):
    d, store = ec_store
    store.unmount_ec_shards(3, [5])
    os.remove(os.path.join(d, "3" + pl.to_ext(5)))
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)

    async def go():
        report = await s.run_cycle()
        assert report["volumes"] == 0
        assert report["skipped"] == [{"volume": 3, "missing_shards": [5]}]
    run(go())


# ---------------------------------------------------------------------
# pacing behavior
# ---------------------------------------------------------------------

def test_scrub_stays_under_byte_budget(ec_store):
    """With the budget set so one cycle needs multiple refills, the
    paced sleep accounts for (total bytes - burst) at the configured
    rate — the scrubber cannot read faster than -scrub.mbps."""
    _, store = ec_store
    s = Scrubber(store, mbps=4.0, window_bytes=WINDOW, pause_ms=0.0)
    rate = 4.0 * (1 << 20)
    burst = float(WINDOW * gf.TOTAL_SHARDS)   # exactly one window
    clock = {"t": 0.0}
    slept = []
    real_sleep = asyncio.sleep

    async def counting_sleep(t):
        slept.append(t)
        clock["t"] += t           # deterministic: time advances only
        await real_sleep(0)       # by the paced sleeps themselves

    s.bucket = TokenBucket(rate, burst_bytes=burst,
                           now=lambda: clock["t"], sleep=counting_sleep)

    async def go():
        report = await s.run_cycle()
        assert report["windows"] > 1, "fixture too small to pace"
        # every byte beyond the initial burst was paid for at the
        # configured rate — sustained scrub I/O == the budget
        expect = (report["bytes"] - burst) / rate
        assert sum(slept) == pytest.approx(expect, rel=1e-6)
        assert s.paced_sleep_s == pytest.approx(sum(slept), rel=1e-6)
    run(go())


def test_scrub_pauses_while_foreground_hot(ec_store):
    _, store = ec_store
    load = ForegroundLoad()
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW,
                 pause_ms=50.0, pause_window_s=30.0, load=load)
    load.note(0.2)    # a slow foreground request just happened

    async def clear_later():
        await asyncio.sleep(0.3)
        load.clear()

    async def go():
        t = asyncio.create_task(clear_later())
        report = await s.run_cycle()
        await t
        assert s.pauses >= 1          # parked at least once
        assert report["corrupt"] == 0  # then finished the pass
    run(go())


# ---------------------------------------------------------------------
# the port's failpoint registry is its own
# ---------------------------------------------------------------------

def test_failpoints_are_the_ports_own_registry(ec_store):
    """Arming scrub.read on the JAX package's registry plants nothing in
    the port's scrub; arming it on the port's registry does."""
    from seaweedfs_tpu.util import failpoints as ref_fp
    _, store = ec_store
    s = Scrubber(store, mbps=0.0, window_bytes=WINDOW, pause_ms=0.0)
    ref_fp.reset()
    ref_fp.arm("scrub.read", "flip:3")
    try:
        assert not fp.armed()
        report = run(s.run_cycle())
        assert report["corrupt"] == 0
    finally:
        ref_fp.reset()
    fp.arm("scrub.read", "flip:3")
    report = run(s.run_cycle())
    assert report["corrupt"] == 1


def test_debug_scrub_endpoint(tmp_path):
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            async with c.http.get(
                    f"http://{vs.url}/debug/scrub") as r:
                assert r.status == 200
                body = await r.json()
            st = body["scrub"]
            assert st["enabled"] is False     # default interval 0
            assert st["state"] == "idle"
            # POST ?run=1 forces a cycle even with the loop disabled
            async with c.http.post(
                    f"http://{vs.url}/debug/scrub?run=1") as r:
                assert r.status == 200
                body = await r.json()
            assert body["cycle"]["volumes"] == 0
            assert body["status"]["cycles"] == 1
            async with c.http.post(
                    f"http://{vs.url}/debug/scrub") as r:
                assert r.status == 400
    run(go())


def test_debug_scrub_localizes_a_flipped_parity_byte(tmp_path):
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            # -scrub.pausems 0: on a loaded host the cluster's own
            # requests pass 50 ms and would park the cycle; the pause
            # gate has its own case above
            vs.scrubber.pause_ms = 0
            rng = random.Random(11)
            vid = None
            for _ in range(12):
                a = await c.assign()
                vid = int(a["fid"].split(",")[0])
                data = rng.randbytes(rng.randint(1, 3 * LB))
                assert (await c.put(a["fid"], a["url"], data))[0] == 201
            # EC-encode the volume of the last fid (it holds >= 1 needle)
            for path in ("/admin/volume/readonly", "/admin/ec/generate",
                         "/admin/ec/mount", "/admin/volume/delete"):
                async with c.http.post(f"http://{vs.url}{path}",
                                       params={"volume": str(vid)}) as r:
                    assert r.status == 200, (path, await r.text())
            base = vs._base_name(vid, "")
            with open(base + pl.to_ext(12), "r+b") as f:
                f.seek(100)
                b = f.read(1)
                f.seek(100)
                f.write(bytes([b[0] ^ 0x01]))
            async with c.http.post(
                    f"http://{vs.url}/debug/scrub?run=1") as r:
                assert r.status == 200
                cycle = (await r.json())["cycle"]
            assert cycle["errors"] == []
            found = [(w["volume"], w["offset"], w["shards"])
                     for w in cycle["corrupt_windows"]]
            assert found == [(vid, 0, [12])], cycle
    run(go())
