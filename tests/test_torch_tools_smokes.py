"""The port's three wire smokes (seaweedfs_tpu_torch/tools/
{wire,recorder,fabric}_smoke.py) pass against the port's CLI on this
host: each runs as `python -m seaweedfs_tpu_torch.tools.<name>` with
SWTPU_TORCH_SMOKE_PORT pointed at a block of free ports and
SWTPU_TORCH_EC_BACKEND=cpu, under a time limit of its own."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

from test_torch_tools import free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,timeout", [("wire_smoke", 240),
                                          ("recorder_smoke", 240),
                                          ("fabric_smoke", 240)])
def test_smoke_passes_against_the_port(name, timeout):
    env = dict(os.environ, SWTPU_TORCH_EC_BACKEND="cpu",
               SWTPU_TORCH_SMOKE_PORT=str(free_port_block(12)))
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", f"seaweedfs_tpu_torch.tools.{name}"],
        cwd=REPO, env=env, capture_output=True, text=True,
        timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("smoke: OK")
