"""Chaos smoke of the port (marked slow, as the reference's
tests/test_chaos_quick.py is — excluded from tier-1): a short
`python -m seaweedfs_tpu_torch.tools.chaos --quick` run against port
daemons with real subprocesses, armed failpoints and a volume-server
SIGKILL must finish with zero acknowledged-write loss. On a host without
a card SWTPU_TORCH_EC_BACKEND=cpu puts the servers' EC engine on the
CPU."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_chaos_quick(tmp_path):
    report_path = str(tmp_path / "chaos.json")
    env = dict(os.environ, SWTPU_TORCH_EC_BACKEND="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.tools.chaos",
         "--quick", "--json", report_path],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=420)
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr)
    assert out.returncode == 0, "chaos soak failed"
    with open(report_path) as f:
        report = json.load(f)
    assert report["verdict"] == "PASS"
    assert report["lost"] == 0
    assert report["stats"]["writes_ok"] > 0
