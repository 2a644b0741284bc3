"""Cache-churn smoke of the port (marked slow, as the reference's
tests/test_cache_churn.py is — excluded from tier-1): a short
`python -m seaweedfs_tpu_torch.tools.soak cache-churn` run against a
real port `-workers 2` cluster with the hot-needle and chunk caches on
and failpoints armed. Every read is byte-verified; any stale read (old
bytes after an overwrite, success after a delete) fails the soak. The
churn's length and file count are SWTPU_TORCH_CHURN_SECONDS and
SWTPU_TORCH_CHURN_FILES (the reference's SWTPU_CHURN_*)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_cache_churn_quick(tmp_path):
    env = dict(os.environ, SWTPU_TORCH_EC_BACKEND="cpu",
               SWTPU_TORCH_CHURN_SECONDS="8", SWTPU_TORCH_CHURN_FILES="120")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "seaweedfs_tpu_torch.tools.soak",
         "cache-churn"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    sys.stdout.write(out.stdout)
    sys.stderr.write(out.stderr)
    assert out.returncode == 0, "cache churn soak reported stale/lost reads"
    assert "stale" in out.stdout        # the verifier actually ran
