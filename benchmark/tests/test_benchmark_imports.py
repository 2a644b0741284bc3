"""No run loads JAX or the JAX package: compared by whole top-level
names, since the port's name begins with the JAX package's."""

import json
import os
import subprocess
import sys
import types

from benchmark import harness

from .small import ROOT


def test_whole_top_level_names(monkeypatch):
    for name in ("seaweedfs_tpu_torch", "seaweedfs_tpu_torchx",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    for name in ("jax", "jaxlib", "flax", "seaweedfs_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "seaweedfs_tpu.ec",
                        types.ModuleType("seaweedfs_tpu.ec"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax", "seaweedfs_tpu"]


def test_a_run_loads_neither(tmp_path):
    """A whole run of each cell, in a process of its own on the host,
    leaves no module of JAX or of the JAX package loaded."""
    from . import small
    root = small.make(str(tmp_path))
    code = (
        "import json, sys, time\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from benchmark import harness\n"
        f"root = {root!r}\n"
        "out = {}\n"
        "for wl in ('s3parts.get-4lost',):\n"
        "    r = harness.run_cell(root, wl, 2**33 + 1, 0.3, True, 'none',\n"
        "                         time.perf_counter(), 'cpu')\n"
        "    out[wl] = r['correct']\n"
        "print(json.dumps({'correct': out,\n"
        "                  'forbidden': harness.forbidden_modules(),\n"
        "                  'port': 'seaweedfs_tpu_torch' in sys.modules}))\n")
    env = dict(os.environ, SWTPU_TORCH_EC_BACKEND="cpu")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] == {"s3parts.get-4lost": True}
    assert got["port"] is True
    assert got["forbidden"] == []


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command prints no result and fails; in a
    directory with only the benchmark it fails too."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = [sys.executable, "-m", "benchmark.run", "--workload",
            "s3parts.get-4lost", "--seed", "5", "--seconds", "1", "--trace", "0"]
    proc = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
