"""The port's bench_pipeline (seaweedfs_tpu_torch/tools/bench_pipeline.py)
on a small volume under SWTPU_TORCH_EC_BACKEND=cpu: its one JSON line has
the JAX package's keys, no host-to-device rate is claimed without a card,
and the shards it writes through the port's TorchEncoder are
sha256-equal to the JAX package's write_ec_files with its CpuEncoder on
the same .dat."""

import hashlib
import json
import os
import shutil

import pytest
import torch

from seaweedfs_tpu_torch.tools import bench_pipeline as port

KEYS = {"metric", "volume_mb", "buffer_mb", "backend",
        "host_to_device_GBps", "kernel_GBps", "pipeline_GBps",
        "pipeline_seconds", "bound_GBps", "pipeline_vs_bound"}


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread here and in every subprocess: the plain
    versions' thread pools in six xdist workers would oversubscribe the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _shard_sums(base: str) -> list[str]:
    out = []
    for sid in range(14):
        with open(base + ".ec%02d" % sid, "rb") as f:
            out.append(hashlib.sha256(f.read()).hexdigest())
    return out


def test_line_and_shards_equal_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    work = tmp_path / "port"
    work.mkdir()
    out = port.run(3, 1, workdir=str(work))
    assert set(out) == KEYS
    json.dumps(out)
    assert out["metric"] == "ec_pipeline_GBps" and out["backend"] == "cpu"
    assert out["host_to_device_GBps"] is None
    assert out["bound_GBps"] == out["kernel_GBps"] > 0
    assert out["pipeline_GBps"] > 0

    from seaweedfs_tpu.ec import pipeline as ref_pl
    from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder
    ref = tmp_path / "ref"
    ref.mkdir()
    shutil.copy(work / "1.dat", ref / "1.dat")
    ref_pl.write_ec_files(str(ref / "1"), encoder=CpuEncoder(),
                          buffer_size=1 << 20)
    assert _shard_sums(str(work / "1")) == _shard_sums(str(ref / "1"))
    assert os.path.getsize(work / "1.dat") == 3 << 20


def test_main_prints_one_line(monkeypatch, capsys):
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    port.main(["1", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and set(json.loads(lines[0])) == KEYS


@pytest.mark.gpu
def test_pipeline_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    out = port.run(16, 4, workdir=str(tmp_path))
    assert out["backend"] == "gpu" and out["host_to_device_GBps"] > 0
