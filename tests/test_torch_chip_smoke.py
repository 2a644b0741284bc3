"""chip_smoke.py refuses to run without a CUDA device, and in a directory
that holds it alone: it exits non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(cwd: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the script would run")
    proc = _run(REPO)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert "seaweedfs_tpu_torch" in proc.stderr
    assert '"ok": true' not in proc.stdout


def test_stacked_and_mesh_phases_rehearse_on_the_cpu(monkeypatch, tmp_path):
    """Phase 2's stacked cases and phase 6 (the mesh path on a group of
    one) at a small size on the CPU, where the plain versions stand in
    for the kernel: every check passes and nothing counts as a launch."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from seaweedfs_tpu_torch.parallel import dist as pdist

    cpu = torch.device("cpu")
    assert chip_smoke.phase_stacked_vs_plain(cpu, 0) == 0
    with pdist.init("cpu", "file://" + str(tmp_path / "rdzv")):
        seen = chip_smoke.phase_mesh(cpu, 0, 3, 4096 + 7)
    assert seen["mesh"] == (1, 1) and seen["max_abs_err"] == 0
    assert (seen["launches"], seen["stacked_launches"]) == (0, 0)
    assert seen["per_call"] == [0, 0, 0]
    assert seen["encoded"].shape == (3, 14, 4096 + 7)


def test_device_busy_counts_kernels_and_copies_over_the_device_window(
        monkeypatch):
    """Only kernel, memcpy and memset spans count; overlaps count once;
    the window runs from the first such span to the last; host ops,
    runtime calls and annotations are ignored even where they are long."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke

    d = chip_smoke.device_busy([
        ("cpu_op", 0, 10_000, "aten::index"),
        ("cuda_runtime", 50, 60, "cudaLaunchKernel"),
        ("gpu_user_annotation", 90, 500, "nccl:all_gather"),
        ("kernel", 100, 200, "gf256_transform"),
        ("kernel", 150, 250, "gf256_transform"),
        ("gpu_memcpy", 300, 350, "Memcpy DtoD"),
        ("gpu_memset", 390, 400, "Memset"),
    ])
    assert (d["busy_ns"], d["window_ns"]) == (210, 300)
    assert d["idle_share"] == pytest.approx(1 - 210 / 300)
    assert d["by_name"]["gf256_transform"] == (200, 2)
    assert "aten::index" not in d["by_name"]
    empty = chip_smoke.device_busy([("cpu_op", 0, 10, "aten::add")])
    assert empty["idle_share"] is None and empty["busy_ns"] == 0


def test_trace_events_read_back_a_profiler_trace(monkeypatch):
    """A CPU trace read back through its Chrome trace: host ops with
    their category and a span in ns, and no device time; the trace file
    is removed after."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(1000).mul(3).sum()
    events = chip_smoke.trace_events(prof)
    ops = [e for e in events if e[0] == "cpu_op"]
    assert any(name == "aten::mul" for _, _, _, name in ops)
    assert all(end >= start for _, start, end, _ in ops)
    assert chip_smoke.device_busy(events)["idle_share"] is None
    assert not os.path.exists(chip_smoke.WORK_DIR)
