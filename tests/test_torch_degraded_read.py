"""Degraded-read failover: the acknowledged copy of a replicated write
must stay readable when a holder dies — including a holder that dies
MID-BODY (the read resumes on the next replica via Range) — and the
client-side circuit breaker must be observed opening against the dead
upstream and recovering through half-open.

The cases of tests/test_degraded_read.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own registries.
Its filer case waits for the port's filer.
"""

import pytest

from seaweedfs_tpu_torch.util import failpoints as fp
from seaweedfs_tpu_torch.util.client import OperationError, WeedClient
from seaweedfs_tpu_torch.util.resilience import BreakerRegistry, RetryPolicy

from test_torch_cluster_util import Cluster, run


@pytest.fixture(autouse=True)
def _clean_registry():
    fp.reset()
    yield
    fp.reset()


async def _write_replicated(c: Cluster, data: bytes) -> tuple[str, list]:
    a = await c.assign(replication="001")
    assert "fid" in a, a
    st, _ = await c.put(a["fid"], a["url"], data)
    assert st == 201
    async with c.http.get(
            f"http://{c.master.url}/dir/lookup",
            params={"volumeId": a["fid"].split(",")[0]}) as r:
        locs = (await r.json())["locations"]
    assert len(locs) == 2, locs
    return a["fid"], locs


def _server_by_url(c: Cluster, url: str):
    for vs in c.servers:
        if vs.url == url:
            return vs
    raise AssertionError(f"no server {url}")


def test_holder_death_mid_replicated_write_leaves_ack_readable(tmp_path):
    """The regression the chaos soak generalizes: kill the PRIMARY
    holder (the server that acknowledged the write) and the read must
    fail over to the surviving replica location."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            data = b"ack-durability" * 1000
            fid, locs = await _write_replicated(c, data)
            # kill the first lookup location — the one a naive client
            # would dial first
            await _server_by_url(c, locs[0]["url"]).stop()
            async with WeedClient(c.master.url) as wc:
                got = await wc.read(fid)
                assert got == data
                # and the whole-file stream shape too
                got = b"".join([b async for b in wc.read_stream(
                    fid, 0, len(data))])
                assert got == data
    run(go())


def test_mid_stream_truncation_resumes_on_next_replica(tmp_path):
    """A holder that declares the full Content-Length, streams half
    the body and severs the socket (the `truncate` failpoint = a
    volume server dying mid-read) must not fail the read: the stream
    rotates to the other replica and resumes via Range."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            data = bytes(range(256)) * 2048       # 512 KiB, positional
            fid, _ = await _write_replicated(c, data)
            # one truncation: whichever holder serves first dies
            # mid-body; the registry is process-global so the count=1
            # guarantees the OTHER holder serves clean
            fp.arm("volume.read.http", "truncate=0.5:1")
            async with WeedClient(c.master.url) as wc:
                got = await wc.read(fid, offset=0, size=len(data))
            assert fp.pending("volume.read.http") is False  # it fired
            assert got == data                    # byte-exact despite cut
    run(go())


def test_breaker_opens_against_dead_holder_then_half_open_recovers(
        tmp_path):
    """Acceptance: the client-side circuit breaker is observed opening
    (dead upstream) and half-open-recovering (after reset_timeout a
    probe closes it again)."""
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            data = b"breaker-bytes" * 200
            fid, locs = await _write_replicated(c, data)
            dead_url = locs[0]["publicUrl"]
            await _server_by_url(c, locs[0]["url"]).stop()
            breakers = BreakerRegistry(threshold=2, reset_timeout=0.0)
            async with WeedClient(c.master.url,
                                  breakers=breakers) as wc:
                for _ in range(3):
                    assert await wc.read(fid) == data
                br = breakers.get(dead_url)
                # two+ connect failures against the dead holder: OPEN
                assert br.state == br.OPEN
                assert br.open_count >= 1
                # reads keep succeeding off the survivor; the dead
                # holder stays demoted (OPEN) but is never skipped
                failures_before = br.failures
                assert await wc.read(fid) == data
                assert br.state == br.OPEN
                assert br.failures >= failures_before
            # half-open RECOVERY against a live upstream
            live = breakers.get(locs[1]["publicUrl"])
            live.record_failure()
            live.record_failure()
            assert live.state == live.OPEN
            assert live.allow()                # reset_timeout=0: probe
            assert live.state == live.HALF_OPEN
            live.record_success()
            assert live.state == live.CLOSED
    run(go())


def test_all_holders_dead_raises_operation_error(tmp_path):
    async def go():
        async with Cluster(str(tmp_path), n_servers=2) as c:
            data = b"gone" * 100
            fid, _ = await _write_replicated(c, data)
            for vs in list(c.servers):
                await vs.stop()
            async with WeedClient(c.master.url, retry=RetryPolicy(
                    max_attempts=2, base_delay=0.01,
                    total_timeout=5.0)) as wc:
                with pytest.raises(OperationError):
                    await wc.read(fid)
    run(go())

