"""Graceful-shutdown signal handling for long-running commands.

Reference: weed/util/signal_handling.go:19-44 — `OnInterrupt` runs
registered cleanups on SIGINT/SIGTERM/SIGHUP before exit (profile dumps
at weed/util/pprof.go:18-31, store unregister at
weed/command/volume.go:184, graceful HTTP stop at
weed/util/httpdown/http_down.go:360-383).

asyncio re-design: instead of callback registration, the server runners
await `wait_for_interrupt()` and then call their servers' `stop()`
coroutines in order. When the runner returns, `asyncio.run` tears the
loop down and atexit hooks fire — which is what makes
`-cpuprofile`/`-memprofile` (util/pprof.py) produce output for server
commands instead of only for one-shot ones.

A copy of seaweedfs_tpu/util/signals.py in the PyTorch port.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import signal


async def wait_for_interrupt() -> int:
    """Block until SIGINT/SIGTERM/SIGHUP; returns the signal number.

    Handlers are installed on the running loop (they replace any
    inherited disposition — a background job of a non-interactive shell
    starts with SIGINT ignored, and a server must still honor a
    deliberate signal the way the reference's signal.Notify does).
    """
    loop = asyncio.get_running_loop()
    got: asyncio.Future[int] = loop.create_future()
    sigs = (signal.SIGINT, signal.SIGTERM, signal.SIGHUP)

    def fire(num: int) -> None:
        if not got.done():
            got.set_result(num)
        else:
            # second signal while the graceful drain is running: force
            # quit with the conventional fatal-signal status. Handlers
            # stay installed through cleanup (the reference keeps
            # signal.Notify active for the process lifetime) so a
            # re-delivered SIGTERM can never hit the default disposition
            # mid needle-map commit.
            os._exit(128 + num)

    for sig in sigs:
        # non-main threads / exotic loops can't install handlers; a
        # server that can't catch signals still runs, it just exits
        # non-gracefully as before
        with contextlib.suppress(NotImplementedError, OSError,
                                 RuntimeError, ValueError):
            loop.add_signal_handler(sig, fire, int(sig))
    return await got
