"""Flight-recorder debug surfaces over live in-proc servers: the
volume server's /debug/timeline//events//health (forced snapshots,
journal from real store transitions, health schema) and the filer's
reserved-path twins.

The cases of tests/test_flight_recorder.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import pytest

from test_torch_cluster_util import Cluster, run
from seaweedfs_tpu_torch.stats import timeline
from seaweedfs_tpu_torch.util import events


@pytest.fixture(autouse=True)
def _fresh():
    timeline.init(interval_s=10.0, ring=64)
    timeline.reset()
    events.reset()
    yield
    timeline.reset()
    events.reset()


def test_volume_debug_surfaces(tmp_path):
    async def main():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            vs = c.servers[0]
            a = await c.assign()
            await c.put(a["fid"], a["url"], b"x" * 4096)
            base = f"http://{vs.url}"
            # forced snapshot -> at least one window with request hists
            async with c.http.post(
                    f"{base}/debug/timeline?snap=1") as r:
                assert r.status == 200
                await r.json()
            await c.get(a["fid"], a["url"])
            async with c.http.post(
                    f"{base}/debug/timeline?snap=1") as r:
                tl = await r.json()
            assert tl["interval_s"] > 0 and tl["ring"] >= 4
            assert tl["windows"], "forced snapshots must yield windows"
            win = tl["windows"][-1]
            for k in ("wall_ms", "dt_s", "rates", "gauges", "hist",
                      "quantiles"):
                assert k in win
            assert any("build_info" in k for k in win["gauges"])
            # POST without ?snap=1 is a client error
            async with c.http.post(f"{base}/debug/timeline") as r:
                assert r.status == 400
            # clamped query params never 500
            async with c.http.get(
                    f"{base}/debug/timeline?n=-5") as r:
                assert r.status == 200
                assert (await r.json())["windows"] == []
            async with c.http.get(
                    f"{base}/debug/timeline?n=999999999") as r:
                assert r.status == 200
            async with c.http.get(f"{base}/debug/timeline?n=zz") as r:
                assert r.status == 400

            # journal: the allocate above recorded a volume_mount
            async with c.http.get(f"{base}/debug/events") as r:
                assert r.status == 200
                ev = await r.json()
            types = [e["type"] for e in ev["events"]]
            assert "volume_mount" in types
            async with c.http.get(
                    f"{base}/debug/events?type=volume_mount&n=1") as r:
                only = await r.json()
            assert len(only["events"]) == 1
            assert only["events"][0]["type"] == "volume_mount"

            # health: stable schema with no -slo configured
            async with c.http.get(f"{base}/debug/health") as r:
                assert r.status == 200
                h = await r.json()
            assert h["status"] == "ok" and h["objectives"] == []

            # traces clamp regression on the live route
            async with c.http.get(
                    f"{base}/debug/traces?n=-1&slowest=999999999") as r:
                assert r.status == 200

    run(main())


def test_filer_recorder_twins(tmp_path):
    async def main():
        c = Cluster(str(tmp_path), n_servers=1)
        c.with_filer = True
        async with c:
            base = f"http://{c.filer.url}"
            async with c.http.post(
                    f"{base}/__debug__/timeline?snap=1") as r:
                assert r.status == 200
            async with c.http.get(f"{base}/__debug__/timeline") as r:
                assert r.status == 200
                assert "windows" in await r.json()
            async with c.http.get(f"{base}/__debug__/events") as r:
                assert r.status == 200
                assert "events" in await r.json()
            async with c.http.get(f"{base}/__debug__/health") as r:
                assert r.status == 200
                h = await r.json()
            assert h["status"] in ("ok", "warn", "page")

    run(main())


def test_master_recorder_routes(tmp_path):
    async def main():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            base = f"http://{c.master.url}"
            async with c.http.post(
                    f"{base}/debug/timeline?snap=1") as r:
                assert r.status == 200
            async with c.http.get(f"{base}/debug/events") as r:
                assert r.status == 200
            async with c.http.get(f"{base}/debug/health") as r:
                assert (await r.json())["status"] == "ok"

    run(main())
