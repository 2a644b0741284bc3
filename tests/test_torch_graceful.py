"""Graceful-shutdown contract of the CLI server commands.

Reference: weed/util/signal_handling.go:19-44 (OnInterrupt cleanups) +
weed/util/pprof.go:18-31 (profile dump on interrupt). SIGTERM must stop
the server loop, run the servers' stop() path (store close / needle-map
commit), exit rc=0, and fire atexit hooks so -cpuprofile produces output.

The case of tests/test_graceful.py pointed at the port's CLI, with
-ecBackend cpu (the port's server refuses to start without a card
otherwise) and -port 0 (the server prints the address it bound).
"""

import os
import signal
import subprocess
import sys
import time


def test_sigterm_stops_volume_server_and_dumps_profile(tmp_path):
    prof = tmp_path / "vol.prof"
    log = tmp_path / "out.log"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    with open(log, "w") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch.cli", "volume",
             "-port", "0", "-dir", str(tmp_path / "v"), "-max", "2",
             "-master", "127.0.0.1:1", "-cpuprofile", str(prof),
             "-ecBackend", "cpu"],
            stdout=lf, stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if "listening" in log.read_text():
                break
            if proc.poll() is not None:
                raise AssertionError(
                    f"server died on startup: {log.read_text()}")
            time.sleep(0.2)
        else:
            raise AssertionError(f"server never came up: {log.read_text()}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        assert rc == 0, f"non-graceful exit rc={rc}: {log.read_text()}"
        assert prof.exists() and prof.stat().st_size > 0, \
            "-cpuprofile produced no output on SIGTERM"
    finally:
        if proc.poll() is None:
            proc.kill()
