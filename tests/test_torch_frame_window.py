"""The frame channel's congestion window (util/frame.py, FrameChannel)
against a step in the peer's service time and against real queueing.

A slower disk, a pause or a cold cache raises every RTT at once, with
one request in flight as with eight. The channel must tell that from
queueing at the peer (RTT rising with the requests in flight), or a
floor kept from a fast phase holds the window at one request: the
reference's FrameChannel (seaweedfs_tpu.util.frame) does, and the cases
below show it on the same feed. The port's floor expires when the last
CWND_INIT requests written with none of the channel's others in flight
all came back over twice it; the window then grows back additively. It
still shrinks in front of a peer that serves one request at a time,
also when other channels share that peer.
"""

from __future__ import annotations

import asyncio
import time

import pytest

from test_torch_cluster_util import run
from seaweedfs_tpu.util import frame as ref_frame
from seaweedfs_tpu_torch.util.frame import (
    HELLO, HELLO_OK, MAGIC, REQ, RESP, FrameChannel, FrameDecoder,
    encode_frame)

SERVICE_S = 0.1           # the service time after the step
OUTSTANDING = 8           # requests the callers keep outstanding


class _StepPeer:
    """A frame peer whose service time the test sets: each request
    sleeps `service` seconds, in a task of its own (`serial=False`, as
    the frame server runs one task per frame) or inline, one at a time
    (`serial=True`). `arrivals` holds, for each request, its arrival
    time and how many requests were at the peer with it."""

    def __init__(self, serial: bool = False):
        self.serial = serial
        self.service = 0.0
        self.at_once = 0
        self.arrivals: list[tuple[float, int]] = []
        self.port = 0
        self._server = None
        self._tasks: set = set()

    async def __aenter__(self):
        self._server = await asyncio.start_server(self._conn,
                                                  "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        self._server.close()
        await self._server.wait_closed()
        for t in list(self._tasks):
            t.cancel()

    async def _conn(self, reader, writer):
        dec = FrameDecoder()
        first = True
        try:
            while True:
                chunk = await reader.read(65536)
                if not chunk:
                    return
                if first and chunk.startswith(MAGIC):
                    chunk = chunk[len(MAGIC):]
                first = False
                for fr in dec.feed(chunk):
                    if fr.type == HELLO:
                        writer.write(encode_frame(HELLO_OK, fr.req_id,
                                                  {"v": 1}))
                    elif fr.type == REQ and self.serial:
                        await self._serve(fr.req_id, writer)
                    elif fr.type == REQ:
                        t = asyncio.create_task(
                            self._serve(fr.req_id, writer))
                        self._tasks.add(t)
                        t.add_done_callback(self._tasks.discard)
        except (OSError, asyncio.CancelledError):
            pass
        finally:
            writer.close()

    async def _serve(self, req_id: int, writer) -> None:
        self.at_once += 1
        self.arrivals.append((time.monotonic(), self.at_once))
        try:
            if self.service:
                await asyncio.sleep(self.service)
            writer.write(encode_frame(RESP, req_id, {"s": 200}, b"ok"))
        finally:
            self.at_once -= 1


async def _drive(channel_cls, peer: _StepPeer, warm_s: float,
                 armed_s: float, service: float):
    """OUTSTANDING callers keep a request each on one channel: `warm_s`
    at the peer's initial service time, then `armed_s` at `service`.
    Returns the channel, the step's time, each request's (sent, done)
    times and the window after each response."""
    ch = channel_cls(target=f"127.0.0.1:{peer.port}")
    stop = asyncio.Event()
    done: list[tuple[float, float]] = []
    windows: list[tuple[float, int]] = []

    async def caller() -> None:
        while not stop.is_set():
            t = time.monotonic()
            st, _, body = await ch.request("GET", "/x", timeout=10.0)
            assert st == 200 and body == b"ok"
            now = time.monotonic()
            done.append((t, now))
            windows.append((now, ch.window))

    try:
        tasks = [asyncio.create_task(caller())
                 for _ in range(OUTSTANDING)]
        await asyncio.sleep(warm_s)
        peer.service = service
        t_step = time.monotonic()
        await asyncio.sleep(armed_s)
        stop.set()
        await asyncio.gather(*tasks)
    finally:
        await ch.close()
    return ch, t_step, done, windows


@pytest.mark.parametrize("package", ["port", "reference"])
def test_service_time_step_keeps_requests_overlapping(package):
    """(a) The peer's service time steps from about 0 to 100 ms under 8
    outstanding requests. The port's channel reads the first RTTs as
    queueing and falls to one request; CWND_INIT lone RTTs later its
    floor expires, and within 16 RTTs of the step at least 4 requests
    are at the peer at once, then all 8. The reference's, fed the
    same, holds the window at 2 or less from the third RTT to the end
    of the run."""
    cls = FrameChannel if package == "port" else ref_frame.FrameChannel

    async def body():
        async with _StepPeer() as peer:
            ch, t_step, done, windows = await _drive(
                cls, peer, warm_s=0.3, armed_s=24 * SERVICE_S,
                service=SERVICE_S)
            # what was admitted before the step reads as queueing for
            # two RTTs (a warm window may be far above 8); from the
            # third RTT on, the window decides alone
            t_from = t_step + 3 * SERVICE_S
            soon = [n for t, n in peer.arrivals
                    if t_step <= t <= t_step + 16 * SERVICE_S]
            last = [n for t, n in peer.arrivals
                    if t >= t_step + 20 * SERVICE_S]
            after = [n for t, n in peer.arrivals if t >= t_from]
            later_windows = [w for t, w in windows if t >= t_from]
            return ch, soon, last, after, later_windows

    ch, soon, last, after, later_windows = run(body())
    assert after, "no request reached the peer from the third RTT on"
    if package == "port":
        assert max(soon) >= 4, (max(soon), ch.stats.to_dict())
        assert max(last) == OUTSTANDING, (last, ch.stats.to_dict())
        assert ch.stats.service_steps >= 1
    else:
        # the reference's lifelong floor reads every 100 ms RTT as
        # queueing: the window cycles 1, 1, 2 and the callers queue
        assert max(after) <= 2, max(after)
        assert max(later_windows) <= 2, later_windows
        assert ch.window <= 2


@pytest.mark.parametrize("package", ["port", "reference"])
def test_serial_peer_still_shrinks_the_window(package):
    """(b) A peer that serves one request at a time: each RTT grows
    with the requests ahead of it, which is queueing, and the window
    shrinks below CWND_INIT and stays there, in the port as in the
    reference."""
    cls = FrameChannel if package == "port" else ref_frame.FrameChannel

    async def body():
        async with _StepPeer(serial=True) as peer:
            peer.service = 0.02
            ch, _, done, windows = await _drive(
                cls, peer, warm_s=0.0, armed_s=1.2, service=0.02)
            return ch, done, windows, peer

    ch, done, windows, peer = run(body())
    assert max(n for _, n in peer.arrivals) == 1     # one at a time
    assert ch.stats.window_shrinks > 0
    assert ch.window < FrameChannel.CWND_INIT
    late = [w for _, w in windows[len(windows) // 2:]]
    assert sum(late) / len(late) < FrameChannel.CWND_INIT / 2, late


def test_lone_rtts_over_the_bound_expire_the_floor():
    """The rule on its own: after a collapse, the floor expires only
    when CWND_INIT lone RTTs in a row all exceed twice it, and becomes
    the lowest of them; the window then grows by one a response at one
    request, not back to CWND_INIT. One jittered lone RTT moves nothing,
    RTTs over the new bound still shrink, and a faster RTT lowers the
    floor at once."""
    ch = FrameChannel(target="127.0.0.1:1")
    k = int(FrameChannel.CWND_INIT)
    for _ in range(200):
        ch._observe_rtt(0.002, alone=True)
    ch._observe_rtt(0.0045, alone=True)       # one jittered sample
    for _ in range(20):
        ch._observe_rtt(0.002, alone=True)
    assert ch._rtt_best == pytest.approx(0.002)
    assert ch.stats.service_steps == 0
    for _ in range(50):
        ch._observe_rtt(0.25)
    assert ch.window == FrameChannel.CWND_MIN
    for i in range(k - 1):
        ch._observe_rtt(0.26 - 0.001 * i, alone=True)
        assert ch._rtt_best == pytest.approx(0.002)
        assert ch.window == FrameChannel.CWND_MIN
    assert ch.stats.service_steps == 0
    ch._observe_rtt(0.27, alone=True)
    assert ch._rtt_best == pytest.approx(0.26 - 0.001 * (k - 2))
    assert ch.stats.service_steps == 1
    assert ch.window == 2
    ch._observe_rtt(0.4, alone=True)          # within the new bound
    assert ch.stats.service_steps == 1
    shrinks = ch.stats.window_shrinks
    ch._observe_rtt(0.6)                       # queueing at the new floor
    assert ch.stats.window_shrinks == shrinks + 1
    ch._observe_rtt(0.001, alone=True)         # a faster peer: lower floor
    assert ch._rtt_best == pytest.approx(0.001)
    assert ch.stats.service_steps == 1


def test_window_at_its_minimum_does_not_grow_over_the_bound():
    """200 RTTs of 2 ms, then 400 of 250 ms, none of them alone: the
    port's window falls to CWND_MIN and stays there, with no growth
    while every RTT is over the bound. The reference's grows back to 2
    on the next response at its minimum and shrinks again, a cycle of
    1, 1, 2 (hundreds of grows on this feed)."""
    port = FrameChannel(target="127.0.0.1:1")
    ref = ref_frame.FrameChannel(target="127.0.0.1:1")
    for ch in (port, ref):
        for _ in range(200):
            ch._observe_rtt(0.002)
    grows = (port.stats.window_grows, ref.stats.window_grows)
    seen = {"port": set(), "ref": set()}
    for _ in range(400):
        port._observe_rtt(0.25)
        ref._observe_rtt(0.25)
        seen["port"].add(port.window)
        seen["ref"].add(ref.window)
    assert port.window == FrameChannel.CWND_MIN
    assert port.stats.window_grows == grows[0]
    assert ref.stats.window_grows > grows[1] + 100
    assert ref.window <= 2 and 2 in seen["ref"]
    assert port._rtt_best == pytest.approx(0.002)
    assert ref._rtt_best == pytest.approx(0.002)


def test_channels_sharing_a_serial_peer_keep_shrinking():
    """Three channels, 8 callers each, on one peer that serves one
    request at a time: whatever one channel's requests meet, the
    others' queue too. Each window still shrinks after its first
    collapse, stays below CWND_INIT and keeps shrinking to the end,
    though every lone RTT is over twice a floor taken alone."""
    async def body():
        async with _StepPeer(serial=True) as peer:
            peer.service = 0.005
            chans = [FrameChannel(target=f"127.0.0.1:{peer.port}")
                     for _ in range(3)]
            for ch in chans:        # floors taken with the peer idle
                await ch.request("GET", "/x", timeout=10.0)
            stop = asyncio.Event()
            windows: list[list[tuple[float, int]]] = [[] for _ in chans]

            async def caller(i: int) -> None:
                while not stop.is_set():
                    await chans[i].request("GET", "/x", timeout=10.0)
                    windows[i].append((time.monotonic(),
                                       chans[i].window))

            t0 = time.monotonic()
            tasks = [asyncio.create_task(caller(i))
                     for i in range(3) for _ in range(OUTSTANDING)]
            await asyncio.sleep(1.0)
            half = [ch.stats.window_shrinks for ch in chans]
            await asyncio.sleep(1.0)
            stop.set()
            await asyncio.gather(*tasks)
            try:
                return t0, chans, windows, half
            finally:
                for ch in chans:
                    await ch.close()

    t0, chans, windows, half = run(body())
    for ch, seen, shrinks in zip(chans, windows, half):
        settled = [w for t, w in seen if t >= t0 + 0.5]
        assert settled and max(settled) < FrameChannel.CWND_INIT, (
            max(settled), ch.stats.to_dict())
        assert ch.stats.window_shrinks > shrinks, ch.stats.to_dict()
