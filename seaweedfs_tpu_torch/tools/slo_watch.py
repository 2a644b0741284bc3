"""Run `soak slo --quick` and read the fleet's `/status` `frames` over
its armed phase.

    python -m seaweedfs_tpu_torch.tools.slo_watch [--out FILE.json]
        [--summarize FILE.json]

The scenario runs as the soak driver runs it, in a process of its own,
from the checkout this is run in. This script stamps each of its lines
with the time it arrived, and reads the volume server's `/status`
`frames` block (every worker's outbound frame channels, the sibling hop
among them) every 5 s. The failpoints are armed right after the last
`healthy phase:` line, so the armed phase is measured from that line:

- its reads per second, from the scenario's own `reads=` counts and the
  times of its lines, up to the page or the last armed line;
- the page's time after arming with its burns, or the last line's;
- per worker and channel, each counter's growth from the first `/status`
  read after arming to the last one before the page or the last armed
  line (requests, window shrinks and grows, service steps).

The last line is one JSON object with those numbers and the wall
seconds; `--out` writes it with every line and `/status` read too, and
`--summarize` reads such a file again. The exit code is the
scenario's."""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

POLL_S = 5.0


def _status_frames(port: int) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                timeout=10) as r:
        return json.loads(r.read()).get("frames", {})


def _wait_closed(port: int, limit_s: float = 10.0) -> None:
    """The scenario SIGKILLs the `-workers` supervisor; its workers
    exit within a second of seeing it gone (`cli._watch_parent`). Wait
    until nothing listens on the fleet's port, so no worker outlives
    this process."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
        except OSError:
            return
        time.sleep(0.2)


def _channel_delta(first: dict, last: dict) -> dict:
    """Per worker and channel, last minus first of every counter."""
    out = {}
    for w, chans in last.items():
        for key, st in chans.items():
            base = first.get(w, {}).get(key, {})
            out[f"{w} -> {key}"] = {k: v - base.get(k, 0)
                                   for k, v in st.items()}
    return out


def _burns(line: str) -> dict:
    """status, fast_burn, slow_burn, reads and errors from one `healthy
    phase:` or `armed phase:` line."""
    out = {}
    for tok in line.split():
        k, _, v = tok.partition("=")
        if k in ("fast_burn", "slow_burn") and v:
            out[k] = float(v)
        elif k in ("reads", "errors") and v.isdigit():
            out[k] = int(v)
        elif k == "status" and v:
            out[k] = v
    return out


def watch() -> dict:
    """Run the scenario; its exit code, wall seconds, lines and `/status`
    reads, each stamped with the seconds since the start."""
    from . import soak
    vport = soak.BASE_PORT + 121
    lines: list[tuple[float, str]] = []
    polls: list[tuple[float, dict]] = []
    done = threading.Event()
    t0 = time.monotonic()

    def poll() -> None:
        while not done.wait(POLL_S):
            try:
                polls.append((time.monotonic() - t0,
                              _status_frames(vport)))
            except (OSError, ValueError):
                pass                  # the fleet is not up, or is gone

    poller = threading.Thread(target=poll, daemon=True)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "seaweedfs_tpu_torch.tools.soak",
         "slo", "--quick"], stdout=subprocess.PIPE, text=True)
    poller.start()
    try:
        for ln in proc.stdout:
            sys.stdout.write(ln)
            lines.append((time.monotonic() - t0, ln.rstrip("\n")))
        rc = proc.wait()
    finally:
        done.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        poller.join(15)
        _wait_closed(vport)
    return {"rc": rc, "wall_s": time.monotonic() - t0,
            "_lines": lines, "_polls": polls}


def summarize(run: dict) -> dict:
    """The armed phase's numbers from one run of :func:`watch`."""
    lines, polls = run["_lines"], run["_polls"]
    healthy = [(t, _burns(ln)) for t, ln in lines
               if "healthy phase:" in ln]
    armed = [(t, _burns(ln)) for t, ln in lines if "armed phase:" in ln
             and "disarmed" not in ln]
    paged = next(((t, b) for t, b in armed if b.get("status") == "page"),
                 None)
    out: dict = {"rc": run["rc"], "wall_s": run["wall_s"],
                 "paged": paged is not None}
    if healthy and armed:
        t_arm, h = healthy[-1]
        t_end, b = paged or armed[-1]
        reads = b.get("reads", 0) - h.get("reads", 0)
        out.update({
            "healthy_reads": h.get("reads", 0),
            "armed_s": t_end - t_arm,
            "armed_reads": reads,
            "armed_reads_per_s": reads / (t_end - t_arm),
            "armed_errors": b.get("errors", 0) - h.get("errors", 0),
            "page_s": t_end - t_arm if paged else None,
            "at_end": b,
        })
        inside = [f for t, f in polls if t_arm <= t <= t_end]
        if len(inside) >= 2:
            out["frames"] = _channel_delta(inside[0], inside[-1])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None,
                   help="write the summary with every line and read here")
    p.add_argument("--summarize", default=None, metavar="FILE.json",
                   help="summarize a run that --out wrote, again")
    args = p.parse_args(argv)
    if args.summarize:
        with open(args.summarize) as f:
            run = json.load(f)
    else:
        run = watch()
    res = summarize(run)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({**res, "_lines": run["_lines"],
                       "_polls": run["_polls"]}, f)
    print(json.dumps(res), flush=True)
    return res["rc"]


if __name__ == "__main__":
    sys.exit(main())
