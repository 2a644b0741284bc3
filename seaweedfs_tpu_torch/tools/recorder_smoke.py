"""~20s flight-recorder smoke of the port's CLI.

Boots a REAL master + `-workers 2` volume fleet as CLI processes,
writes and reads a handful of needles through the shared public port,
forces a whole-host timeline snapshot, and then SCHEMA-CHECKS the
three recorder surfaces:

  /debug/timeline  — merged windows with rates/gauges/hist/quantiles,
                     build_info + process_start_time gauges present
                     (restart detection), request histograms recorded;
  /debug/events    — merged journal rows with type/wall_ms/mono/trace,
                     at least one volume_mount from the write path;
  /debug/health    — ok with a configured -slo objective evaluated
                     (fast/slow burn rows present);
  /debug/scrub     — merged scrubber status with the machine-readable
                     `reported_windows` list and a forced cycle's
                     `corrupt_windows` rows (the autopilot observer's
                     input schema);
  /debug/autopilot — maintenance-plane status + a forced dry-run
                     cycle's planned/deferred/executed ledger.

Any key drift in these payloads fails CI before a soak or operator
tooling trips over it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PORT = int(os.environ.get("SWTPU_TORCH_SMOKE_PORT", "22050"))


def wait_assign(master: str, tries: int = 60) -> None:
    for _ in range(tries):
        try:
            with urllib.request.urlopen(
                    f"http://{master}/dir/assign", timeout=3) as r:
                if b"fid" in r.read():
                    return
        except OSError:
            pass
        time.sleep(0.5)
    raise RuntimeError("cluster never became assignable")


def get_json(addr: str, path: str, method: str = "GET") -> dict:
    req = urllib.request.Request(f"http://{addr}{path}", method=method)
    with urllib.request.urlopen(req, timeout=15) as r:
        return json.load(r)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(f"schema drift: {what}")


def main() -> int:
    tmp = tempfile.mkdtemp(prefix="swtpu_rec_smoke_")
    env = dict(os.environ, PYTHONPATH=REPO)
    master = f"127.0.0.1:{PORT}"
    vol = f"127.0.0.1:{PORT + 1}"
    procs: list[subprocess.Popen] = []

    def spawn(*args: str) -> None:
        log = open(os.path.join(tmp, f"proc{len(procs)}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", *args],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp))

    try:
        spawn("master", "-port", str(PORT), "-mdir",
              os.path.join(tmp, "m"), "-pulseSeconds", "1",
              "-autopilot.dryrun", "-timeline.interval", "2")
        time.sleep(1.5)
        spawn("volume", "-port", str(PORT + 1), "-dir",
              os.path.join(tmp, "v"), "-max", "10", "-master", master,
              "-pulseSeconds", "1", "-workers", "2",
              "-timeline.interval", "2",
              "-slo", "volume.read:p99<250ms@99",
              "-qos.tenant", "smoke:4:100",
              "-qos.mbps", "50")
        wait_assign(master)

        # traffic across both workers' vid partitions
        fids = []
        for i in range(8):
            a = get_json(master, "/dir/assign")
            body = f"recorder-{i}-".encode() * 64
            req = urllib.request.Request(
                f"http://{a['url']}/{a['fid']}", data=body,
                method="POST", headers={"X-Raw-Needle": "0"})
            with urllib.request.urlopen(req, timeout=10) as r:
                check(r.status in (200, 201), f"write {r.status}")
            fids.append((a["fid"], a["url"]))
        for fid, url in fids:
            with urllib.request.urlopen(f"http://{vol}/{fid}",
                                        timeout=10) as r:
                check(r.status == 200, f"read {r.status}")

        # -- /debug/timeline (forced whole-host snapshot) ---------------
        tl = get_json(vol, "/debug/timeline?snap=1", method="POST")
        for key in ("interval_s", "ring", "windows"):
            check(key in tl, f"/debug/timeline missing {key!r}")
        check(tl["windows"], "/debug/timeline has no windows")
        win = tl["windows"][-1]
        for key in ("wall_ms", "dt_s", "rates", "gauges", "hist",
                    "quantiles"):
            check(key in win, f"timeline window missing {key!r}")
        gk = list(win["gauges"])
        check(any(k.startswith("SeaweedFS_build_info") for k in gk),
              "build_info gauge absent")
        check("SeaweedFS_process_start_time_seconds" in win["gauges"],
              "process_start_time gauge absent")
        hists = [k for w in tl["windows"]
                 for k in w["quantiles"]
                 if k.startswith("SeaweedFS_request_duration_seconds")
                 and 'tier="volume"' in k]
        check(hists, "no volume request histograms in any window")
        qrow = None
        for w in tl["windows"]:
            for k, q in w["quantiles"].items():
                if k in hists:
                    qrow = q
        for key in ("p50", "p95", "p99", "count", "rate"):
            check(key in qrow, f"quantile row missing {key!r}")
        print(f"  timeline: {len(tl['windows'])} merged windows, "
              f"volume read p99={qrow['p99'] * 1000:.1f}ms over "
              f"{int(qrow['count'])} requests")

        # -- /debug/events ---------------------------------------------
        ev = get_json(vol, "/debug/events?n=200")
        for key in ("events", "recorded"):
            check(key in ev, f"/debug/events missing {key!r}")
        check(ev["events"], "journal is empty after allocate traffic")
        row = ev["events"][0]
        for key in ("seq", "type", "wall_ms", "mono", "trace"):
            check(key in row, f"event row missing {key!r}")
        types = {e["type"] for e in ev["events"]}
        check("volume_mount" in types,
              f"no volume_mount in journal (saw {sorted(types)})")
        check(any("worker" in e for e in ev["events"]),
              "merged events carry no worker tags")
        print(f"  events: {len(ev['events'])} rows "
              f"({', '.join(sorted(types))})")

        # -- /debug/health ---------------------------------------------
        h = get_json(vol, "/debug/health")
        for key in ("status", "objectives", "now_ms"):
            check(key in h, f"/debug/health missing {key!r}")
        check(h["status"] == "ok",
              f"healthy fleet reports {h['status']!r}")
        check(len(h["objectives"]) == 1, "configured -slo not evaluated")
        obj = h["objectives"][0]
        for key in ("spec", "status", "fast", "slow", "threshold_ms",
                    "objective"):
            check(key in obj, f"objective row missing {key!r}")
        for key in ("horizon_s", "count", "frac_over", "burn"):
            check(key in obj["fast"], f"burn window missing {key!r}")
        print(f"  health: {h['status']} ({obj['spec']}, fast burn "
              f"{obj['fast']['burn']})")

        # -- /debug/scrub (autopilot observer input schema) -------------
        sc = get_json(vol, "/debug/scrub")
        check("workers" in sc, "/debug/scrub not worker-merged")
        st = next(iter(sc["workers"].values()))
        for key in ("state", "cycles", "corruptions",
                    "reported_windows", "last_cycle"):
            check(key in st, f"scrub status missing {key!r}")
        forced = get_json(vol, "/debug/scrub?run=1", method="POST")
        cyc = next(iter(forced["workers"].values()))["cycle"]
        for key in ("volumes", "windows", "corrupt", "corrupt_windows",
                    "bytes", "skipped", "errors", "seconds"):
            check(key in cyc, f"scrub cycle missing {key!r}")
        print(f"  scrub: {len(sc['workers'])} workers merged, cycle "
              f"keys OK")

        # -- /debug/qos (admission + arbiter schema, -workers merged) ---
        qd = get_json(vol, "/debug/qos")
        check(qd.get("workers") == 2, "/debug/qos not worker-merged")
        q = qd["qos"]
        for key in ("tenants", "inflight", "inflight_limit", "queued",
                    "shed_level", "ladder", "thresholds", "probes",
                    "arbiter"):
            check(key in q, f"/debug/qos missing {key!r}")
        check("smoke" in q["tenants"],
              f"-qos.tenant class absent (saw {sorted(q['tenants'])})")
        trow = q["tenants"]["smoke"]
        for key in ("admitted", "throttled", "shed", "queued", "cls",
                    "weight", "rps", "burst", "tokens", "queue_depth"):
            check(key in trow, f"qos tenant row missing {key!r}")
        arb = q["arbiter"]
        for key in ("budget_mbps", "floor", "foreground_bps",
                    "consumers", "grants"):
            check(key in arb, f"qos arbiter missing {key!r}")
        check("scrub" in arb["consumers"],
              f"scrub bucket not adopted by the arbiter "
              f"(consumers: {sorted(arb['consumers'])})")
        print(f"  qos: {len(q['tenants'])} tenant classes, arbiter "
              f"budget {arb['budget_mbps']} MiB/s, "
              f"{len(arb['consumers'])} adopted consumer(s)")

        # -- raft surfaces on the master (HA control plane schema) ------
        mtl = get_json(master, "/debug/timeline?snap=1", method="POST")
        mg = mtl["windows"][-1]["gauges"]
        for key in ("SeaweedFS_raft_term", "SeaweedFS_raft_commit_index",
                    "SeaweedFS_raft_is_leader"):
            check(key in mg, f"master timeline missing {key!r} gauge")
        check(mg["SeaweedFS_raft_is_leader"] == 1,
              "single-mode master not reporting raft_is_leader=1")
        mev = get_json(master, "/debug/events?n=200"
                       "&type=raft_leader_change")
        check(mev["events"], "no raft_leader_change journal row on a "
                             "booted master")
        lead = mev["events"][0]
        for key in ("leader", "term", "me"):
            check(key in lead, f"raft_leader_change row missing {key!r}")
        print(f"  raft: is_leader gauge + leader_change journal OK "
              f"(term {int(mg['SeaweedFS_raft_term'])})")

        # -- frame fabric (hop-labeled wire accounting schema) ----------
        vfr = [k for w in tl["windows"] for k in w["rates"]
               if k.startswith("SeaweedFS_frame_requests_total")]
        check(vfr, "no frame_requests_total counters on the volume")
        check(any('hop="interhost"' in k and 'side="client"' in k
                  for k in vfr),
              f"volume->master heartbeat not counted as a "
              f"client/interhost frame hop (saw {sorted(set(vfr))})")
        vgauges: dict = {}
        for w in tl["windows"]:
            vgauges.update(w["gauges"])
        open_ch = [k for k in vgauges
                   if k.startswith("SeaweedFS_frame_open_channels")]
        check(any(f'peer="{master}"' in k for k in open_ch),
              f"no per-peer open-channel gauge for the master "
              f"(saw {open_ch})")
        mfr = [k for w in mtl["windows"] for k in w["rates"]
               if k.startswith("SeaweedFS_frame_requests_total")]
        check(any('side="server"' in k for k in mfr),
              f"master served no frame requests (saw {sorted(set(mfr))})")
        print(f"  frames: hop-labeled request counters + "
              f"{len(open_ch)} open-channel gauge(s) OK")

        # -- /debug/autopilot (forced dry-run cycle) --------------------
        ap = get_json(master, "/debug/autopilot")["autopilot"]
        for key in ("enabled", "leader", "dryrun", "state", "cycles",
                    "budget_mbps", "actions_ok", "actions_failed",
                    "bytes_paid", "paced_sleep_s", "in_flight",
                    "history", "last_cycle"):
            check(key in ap, f"/debug/autopilot missing {key!r}")
        check(ap["dryrun"] is True, "autopilot -autopilot.dryrun lost")
        forced = get_json(master, "/debug/autopilot?run=1",
                          method="POST")
        for key in ("wall_ms", "seconds", "dryrun", "observed",
                    "planned", "deferred", "executed"):
            check(key in forced["cycle"],
                  f"autopilot cycle missing {key!r}")
        obs = forced["cycle"]["observed"]
        for key in ("nodes", "volumes", "ec_volumes", "corruptions",
                    "paging", "errors"):
            check(key in obs, f"autopilot observed missing {key!r}")
        check(obs["nodes"] >= 1, "autopilot observed no nodes")
        print(f"  autopilot: dry-run cycle over {obs['nodes']} nodes, "
              f"{len(forced['cycle']['planned'])} planned")
        # -- sharded filer plane (map, redirect hints, debug, events) ---
        import http.client
        f0, f1 = f"127.0.0.1:{PORT + 10}", f"127.0.0.1:{PORT + 11}"
        for sid, fp in ((0, PORT + 10), (1, PORT + 11)):
            spawn("filer", "-port", str(fp), "-ip", "127.0.0.1",
                  "-master", master, "-store", "sqlite",
                  "-dbPath", os.path.join(tmp, f"f{sid}.db"),
                  "-shard.id", str(sid), "-shard.of", "2",
                  "-shard.peers", f"{f0},{f1}")
        for _ in range(60):
            try:
                if {"0", "1"} <= set(get_json(
                        master, "/cluster/shards").get("owners", {})):
                    break
            except OSError:
                pass
            time.sleep(0.5)
        else:
            raise AssertionError("filer shards never registered")
        req = urllib.request.Request(
            f"http://{master}/cluster/shards",
            data=json.dumps({"op": "set", "rules":
                             [["/", 0], ["/shard/t", 1]]}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            check(r.status == 200, f"shard map set -> {r.status}")
        # the foreign-path answer must carry the learnable hint trio
        # (poll: shard 0 adopts the new rule on its ~2s map refresh)
        rr = None
        for _ in range(40):
            c = http.client.HTTPConnection("127.0.0.1", PORT + 10,
                                           timeout=10)
            c.request("GET", "/__api__/lookup?path=/shard/t/x")
            rr = c.getresponse()
            rr.read()
            if rr.status == 307:
                break
            time.sleep(0.5)
        check(rr is not None and rr.status == 307,
              f"foreign path not redirected "
              f"(got {rr.status if rr else '?'})")
        for h in ("X-Shard-Owner", "X-Shard-Prefix", "X-Shard-Epoch"):
            check(rr.getheader(h), f"307 missing {h} hint header")
        check(rr.getheader("X-Shard-Owner") == f1,
              f"wrong owner hint {rr.getheader('X-Shard-Owner')!r}")
        # a tiny real split: seed /shard/u on 0, move it to 1 — the
        # journal must record the flip and the done phases
        for i in range(3):
            body = json.dumps({"FullPath": f"/shard/u/e{i}",
                               "Mtime": 1.0 + i}).encode()
            req = urllib.request.Request(
                f"http://{f0}/__api__/entry", data=body,
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                check(r.status == 200, f"seed entry -> {r.status}")
        req = urllib.request.Request(
            f"http://{master}/cluster/shards",
            data=json.dumps({"op": "split_intent",
                             "prefix": "/shard/u", "to": 1}).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            check(r.status == 200, f"split_intent -> {r.status}")
        for _ in range(60):
            if not get_json(master, "/cluster/shards").get("moves"):
                break
            time.sleep(0.5)
        else:
            raise AssertionError("split never drained")
        ds = get_json(f0, "/__debug__/shards")
        for key in ("shard", "of", "url", "epoch", "entries", "rules",
                    "owners", "moves", "counters", "singleflight"):
            check(key in ds, f"/__debug__/shards missing {key!r}")
        for key in ("local", "redirect", "forward", "merge", "ingest",
                    "moved", "replayed"):
            check(key in ds["counters"],
                  f"shard counters missing {key!r}")
        check(ds["counters"]["moved"] >= 3,
              f"split moved {ds['counters']['moved']} < 3 entries")
        md = get_json(master, "/debug/shards")
        for key in ("epoch", "leader", "map", "shards"):
            check(key in md, f"master /debug/shards missing {key!r}")
        check(len(md["shards"]) == 2,
              f"master fan-out saw {len(md['shards'])} shards")
        sev = get_json(f0, "/__debug__/events?type=shard_split")
        check(sev["events"], "no shard_split journal rows after the "
                             "split")
        for key in ("id", "phase", "shard", "seconds"):
            check(key in sev["events"][0],
                  f"shard_split row missing {key!r}")
        phases = {e["phase"] for e in sev["events"]}
        check({"flip", "done"} <= phases,
              f"split phases incomplete (saw {sorted(phases)})")
        with urllib.request.urlopen(f"http://{f0}/__metrics__",
                                    timeout=10) as r:
            mtext = r.read().decode()
        for name in ("SeaweedFS_filer_shard_requests_total",
                     "SeaweedFS_filer_shard_map_epoch",
                     "SeaweedFS_filer_shard_moved_entries_total"):
            check(name in mtext, f"{name} absent from filer metrics")
        print(f"  shards: 307 hints + split journal (flip/done) + "
              f"map epoch {ds['epoch']} + moved="
              f"{ds['counters']['moved']} OK")

        # -- /debug/profile (continuous profiler, -workers merged) ------
        pr = get_json(vol, "/debug/profile?seconds=0.5")
        for key in ("hz", "running", "window_s", "samples", "folded"):
            check(key in pr, f"/debug/profile missing {key!r}")
        check(pr["samples"] >= 10,
              f"0.5s on-demand window took {pr['samples']} samples "
              f"(expected ~99Hz x 0.5s x 2 workers)")
        check(pr["folded"], "profiler window folded no stacks")
        check(all(";" in k or k == "(other)" for k in pr["folded"]),
              "folded keys not tier-prefixed stack;frames")
        print(f"  profile: {pr['samples']} samples, "
              f"{len(pr['folded'])} folded stacks in 0.5s window")

        # -- /debug/cluster/trace/<id> (cross-host assembly) ------------
        tid = "c0ffee" + "0" * 26
        req = urllib.request.Request(
            f"http://{vol}/{fids[0][0]}",
            headers={"traceparent": f"00-{tid}-00000000000000ab-01"})
        with urllib.request.urlopen(req, timeout=10) as r:
            check(r.status == 200, f"traced read {r.status}")
        ct = get_json(master, f"/debug/cluster/trace/{tid}")
        for key in ("trace_id", "spans", "start_ms", "dur_ms", "tiers",
                    "hosts", "complete", "missing_nodes", "tree"):
            check(key in ct, f"/debug/cluster/trace missing {key!r}")
        check(ct["trace_id"] == tid, "assembled wrong trace id")
        check(ct["spans"] >= 1 and ct["tree"],
              f"traced volume read not assembled (spans={ct['spans']})")
        check(ct["complete"] and not ct["missing_nodes"],
              f"healthy fleet reported missing nodes: "
              f"{ct['missing_nodes']}")
        check("volume" in ct["tiers"],
              f"no volume tier in assembled trace ({ct['tiers']})")
        check(any(s.get("host") for s in ct["tree"]),
              "assembled spans carry no host attribution")
        print(f"  cluster trace: {ct['spans']} span(s) across "
              f"{len(ct['hosts'])} host(s), tiers="
              f"{','.join(ct['tiers'])}")

        # -- /debug/cluster/health (cluster-merged SLO verdict) ---------
        ch = get_json(master, "/debug/cluster/health")
        for key in ("status", "objectives", "now_ms", "nodes",
                    "missing_nodes"):
            check(key in ch, f"/debug/cluster/health missing {key!r}")
        check(ch["nodes"] >= 3,
              f"cluster health merged only {ch['nodes']} nodes "
              f"(want master + volume + 2 filers)")
        check(not ch["missing_nodes"],
              f"healthy fleet missing {ch['missing_nodes']}")
        # exemplar link: the traced read must surface a worst-trace
        # pointer in the volume's timeline window
        tl2 = get_json(vol, "/debug/timeline?snap=1", method="POST")
        exs = {}
        for w in tl2.get("windows", ()):
            exs.update(w.get("exemplars") or {})
        check(exs, "no timeline exemplars after traced traffic")
        check(all("trace" in e and "dur_ms" in e for e in exs.values()),
              "exemplar rows missing trace/dur_ms")
        print(f"  cluster health: {ch['status']} over {ch['nodes']} "
              f"nodes; {len(exs)} exemplar key(s) in the timeline")
        print("recorder smoke: OK")
        return 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        time.sleep(1)   # workers notice the dead supervisor and exit


if __name__ == "__main__":
    sys.exit(main())
