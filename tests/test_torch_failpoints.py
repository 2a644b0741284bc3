"""util/failpoints.py: spec grammar, arming/expiry, env loading, and
the live /debug/failpoints admin endpoint + injected faults end-to-end
against an in-proc cluster.

The cases of tests/test_failpoints.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers (the master too) and
its own registries.
"""

import random

import pytest

from seaweedfs_tpu_torch.util import failpoints as fp

from test_torch_cluster_util import Cluster, run


@pytest.fixture(autouse=True)
def _clean_registry():
    fp.reset()
    yield
    fp.reset()


# ---- spec grammar ----

def test_parse_spec_forms():
    a = fp.parse_spec("s", "error")
    assert (a.action, a.arg, a.count, a.prob) == ("error", "", 1, 1.0)
    a = fp.parse_spec("s", "error=503:3")
    assert (a.action, a.arg, a.count) == ("error", "503", 3)
    a = fp.parse_spec("s", "latency=250")
    assert (a.action, a.arg) == ("latency", "250")
    a = fp.parse_spec("s", "drop:*")
    assert a.count == -1
    a = fp.parse_spec("s", "truncate=0.25@0.5")
    assert (a.action, a.arg, a.prob) == ("truncate", "0.25", 0.5)
    # probabilistic sites default to unlimited count
    assert fp.parse_spec("s", "error@0.05").count == -1
    # ...unless a count is explicit
    assert fp.parse_spec("s", "error:2@0.5").count == 2
    a = fp.parse_spec("s", "flip=3:2")
    assert (a.action, a.arg, a.count) == ("flip", "3", 2)


def test_parse_spec_rejects_garbage():
    for bad in ("explode", "error@1.5", "error@0", "truncate=2",
                "latency=abc", "error=xyz", "flip=0", "flip=-1"):
        with pytest.raises(ValueError):
            fp.parse_spec("s", bad)


def test_arm_take_expiry_and_counting():
    fp.arm("x", "error:2")
    assert fp.pending("x")
    assert fp.take("x").action == "error"
    assert fp.take("x") is not None
    assert fp.take("x") is None          # expired after 2 fires
    assert not fp.pending("x")


def test_probability_respects_rng():
    fp.arm("p", "error@0.5")
    fp._rng = random.Random(7)
    fired = sum(fp.take("p") is not None for _ in range(400))
    assert 120 < fired < 280             # ~200 expected
    assert fp.pending("p")               # unlimited count


def test_sync_fail_and_exception_lineage():
    fp.arm("e", "error=503")
    with pytest.raises(fp.FailpointError) as ei:
        fp.sync_fail("e")
    assert isinstance(ei.value, OSError)
    assert ei.value.status == 503
    fp.arm("d", "drop")
    with pytest.raises(fp.FailpointDrop) as ei:
        fp.sync_fail("d")
    assert isinstance(ei.value, ConnectionResetError)


def test_corrupt_truncates_payload():
    fp.arm("t", "truncate=0.25")
    assert fp.corrupt("t", b"x" * 100) == b"x" * 25
    assert fp.corrupt("t", b"x" * 100) == b"x" * 100  # expired


def test_corrupt_flips_payload_silently():
    """`flip` is bit-rot: same length, corrupt prefix — what the EC
    scrubber (ec/scrub.py) must catch without a foreground error."""
    fp.arm("f", "flip")
    out = fp.corrupt("f", b"\x0f" * 4)
    assert out == b"\xf0" + b"\x0f" * 3 and len(out) == 4
    fp.arm("f2", "flip=100")             # clamps to payload length
    assert fp.corrupt("f2", b"\x00" * 3) == b"\xff" * 3


def test_disarmed_is_free_and_noop():
    assert not fp.armed()
    fp.sync_fail("whatever")             # must not raise
    assert fp.corrupt("whatever", b"ok") == b"ok"
    assert fp.take("whatever") is None


def test_load_env():
    n = fp.load_env("a=error:2, b=latency=10@0.5 ,")
    assert n == 2
    assert fp.pending("a") and fp.pending("b")
    with pytest.raises(ValueError):
        fp.load_env("justasite")
    with pytest.raises(ValueError):
        fp.load_env("a=unknownaction")


# ---- live admin endpoint + injection end-to-end ----

def test_debug_endpoint_and_injected_read_errors(tmp_path):
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            st, _ = await c.put(a["fid"], a["url"], b"payload")
            assert st == 201
            vs = c.servers[0]
            base = f"http://{vs.url}"

            # arm over the wire: one injected read error
            async with c.http.post(
                    f"{base}/debug/failpoints",
                    params={"site": "store.read",
                            "spec": "error=503:1"}) as r:
                assert r.status == 200
                body = await r.json()
                assert body["armed"][0]["site"] == "store.read"

            # first read eats the injected fault (armed status honored)
            st, _ = await c.get(a["fid"], a["url"])
            assert st == 503
            # ...second succeeds (count expired)
            st, data = await c.get(a["fid"], a["url"])
            assert (st, data) == (200, b"payload")

            # list shows the hit; registry is empty again
            async with c.http.get(f"{base}/debug/failpoints") as r:
                assert (await r.json())["failpoints"] == []

            # DELETE disarms
            async with c.http.post(
                    f"{base}/debug/failpoints",
                    params={"site": "store.read", "spec": "error"}) as r:
                assert r.status == 200
            async with c.http.delete(f"{base}/debug/failpoints") as r:
                assert (await r.json())["disarmed"] == 1
            st, _ = await c.get(a["fid"], a["url"])
            assert st == 200
    run(go())


def test_injected_write_error_is_not_acked(tmp_path):
    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            a = await c.assign()
            fp.arm("store.write", "error:1")
            st, _ = await c.put(a["fid"], a["url"], b"data")
            assert st >= 500                  # injected: NOT acknowledged
            st, _ = await c.get(a["fid"], a["url"])
            assert st == 404                  # and really not stored
            st, _ = await c.put(a["fid"], a["url"], b"data")
            assert st == 201
    run(go())


def test_master_assign_failpoint(tmp_path):
    """The master is the port's, so its site is armed in the port's
    registry; arming it in the JAX package's registry injects nothing."""
    from seaweedfs_tpu.util import failpoints as ref_fp

    async def go():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            ref_fp.arm("master.assign", "error:1")
            assert fp.list_armed() == []
            assert "fid" in await c.assign()
            ref_fp.reset()
            fp.arm("master.assign", "error:1")
            body = await c.assign()
            assert "error" in body
            body = await c.assign()
            assert "fid" in body
            st, _ = await c.put(body["fid"], body["url"], b"after")
            assert st == 201
            assert await c.get(body["fid"], body["url"]) == (200, b"after")
    try:
        run(go())
    finally:
        ref_fp.reset()
