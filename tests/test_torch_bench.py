"""The port's bench (seaweedfs_tpu_torch/tools/bench.py, `cli bench-ec`)
keeps the measurement-honesty guards of the JAX package's bench.py
(tests/test_bench.py): a rate above the card's HBM ceiling raises, a
real measurement returns a plausible rate with the chain length it
timed, the degraded-read stage reports coherent percentiles, and the CPU
baseline is positive. Both kernel paths pass the CPU oracle; a path that
is wrong is reported as a mismatch and never timed; a child that yields
nothing gives value 0.0 and a non-zero exit, never the host's rate."""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


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


def _buf(rows: int, k: int, n: int) -> torch.Tensor:
    return torch.ones((1, k + rows, n), dtype=torch.uint8)


def test_hbm_bound_rejects_impossible_rate():
    # a step that does nothing, with an absurd claimed byte count: the
    # computed GB/s exceeds the card's HBM ceiling and must raise, never
    # land in the published result
    coeff = np.zeros((2, 3), np.uint8)
    with pytest.raises(bench.ImplausibleResult):
        bench._chained_gbs(lambda c, x, out: None, coeff, _buf(2, 3, 64),
                           n=1 << 50, chain_len=2, rtt=0.0)


def test_ceilings_count_the_bytes_each_rate_moves():
    # a chain step reads 10 rows and writes 4: 1.4 bytes through HBM for
    # each data byte, so a data rate of 0.8 of the HBM rate is already
    # impossible, and 0.7 is not
    assert bench.ceiling_gbps("encode_GBps") == pytest.approx(3350 / 1.4)
    assert bench.ceiling_gbps("rebuild4_GBps") == pytest.approx(3350 / 1.4)
    assert bench.ceiling_gbps("batched_encode_GBps") == pytest.approx(
        3350 / 2.4)
    assert bench.ceiling_gbps("crc_device_GBps") == 3350
    with pytest.raises(bench.ImplausibleResult):
        bench.check_plausible("encode_GBps", 0.8 * bench.HBM_BOUND_GBPS)
    bench.check_plausible("encode_GBps", 0.7 * bench.HBM_BOUND_GBPS)
    with pytest.raises(bench.ImplausibleResult):
        bench.check_plausible("batched_encode_GBps",
                              0.5 * bench.HBM_BOUND_GBPS)


def test_timed_calls_span_the_target_within_the_budget():
    calls = []

    def call():
        calls.append(1)
        time.sleep(0.002)

    per_call, iters = bench._timed_calls(call, CPU, budget_s=10.0,
                                         target_s=0.1)
    # the round it divides spans the target; the warm call and the
    # shorter rounds before it are not in its count
    assert per_call * iters >= 0.1 and iters >= 2
    assert len(calls) > iters + 2
    assert per_call >= 0.002
    _, capped = bench._timed_calls(call, CPU, budget_s=0.02, target_s=1.0)
    assert 2 <= capped <= 10


def test_chained_gbs_returns_plausible_rate():
    def xor_step(c, x, out):
        torch.bitwise_xor(x[:, :2], x[:, 2:4], out=out)

    coeff = np.zeros((2, 4), np.uint8)
    gbs, dt, used = bench._chained_gbs(xor_step, coeff, _buf(2, 4, 4096),
                                       n=4096, chain_len=2, rtt=0.0)
    assert 0.0 < gbs <= bench.HBM_BOUND_GBPS
    assert dt > 0.0
    # the chain may only GROW to dominate dispatch latency — a shrunken
    # chain would mean dividing by a length that was never run
    assert used >= 2


def test_degraded_read_percentiles_coherent():
    res = bench.bench_degraded_read(n_needles=8, payload=1 << 10, reads=25)
    assert res["degraded_read_reads"] == 25
    assert 0.0 < res["degraded_read_p50_ms"] <= res["degraded_read_p99_ms"]


def test_cpu_baseline_positive():
    gbs, kind = bench.bench_cpu(n_bytes_per_shard=64 << 10)
    assert gbs > 0.0
    assert kind in ("native-avx2", "numpy")


def test_ceiling_is_the_cards(monkeypatch):
    assert bench.HBM_BOUND_GBPS == 3350.0
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    assert chip_smoke.HBM_BYTES_PER_S is bench.HBM_BYTES_PER_S


def test_chain_steps_read_what_the_step_before_wrote():
    k, rows = gf.DATA_SHARDS, gf.PARITY_SHARDS
    buf = torch.arange(k + rows, dtype=torch.uint8)[None, :, None].expand(
        1, k + rows, 8).contiguous()
    base = buf.data_ptr()
    for step in range(4):
        x, out = bench.chain_views(buf, k, rows, step)
        _, prev_out = bench.chain_views(buf, k, rows, step - 1)
        assert x.shape == (1, k, 8) and out.shape == (1, rows, 8)
        x_rows = {(x.data_ptr() - base) // 8 + i for i in range(k)}
        out_rows = {(out.data_ptr() - base) // 8 + i for i in range(rows)}
        prev_rows = {(prev_out.data_ptr() - base) // 8 + i
                     for i in range(rows)}
        assert not x_rows & out_rows
        assert prev_rows <= x_rows
        # views of the one buffer, not copies
        assert x.untyped_storage().data_ptr() == base


def test_both_paths_verified_on_the_cpu():
    assert bench._verify_paths_on_device(CPU, n_small=64 << 10) == {
        "vpu": True, "mxu": True}


def _flip_one_byte(fn):
    def step(c, x, out):
        fn(c, x, out)
        out[0, 0, 7] ^= 1
    return step


def test_a_wrong_path_is_a_mismatch_and_never_timed(monkeypatch, capsys):
    real = bench.kernel_paths
    monkeypatch.setattr(bench, "kernel_paths", lambda dev: {
        "vpu": real(dev)["vpu"], "mxu": _flip_one_byte(real(dev)["mxu"])})
    status = bench._verify_paths_on_device(CPU, n_small=64 << 10)
    assert status == {"vpu": True, "mxu": "MISMATCH vs CPU oracle"}

    # the child itself: mxu is reported and never timed, vpu is
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    monkeypatch.setenv(bench.BYTES_ENV, str(128 << 10))
    monkeypatch.setenv(bench.CHILD_ENV, "40")
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    assert bench.child_main() == 0
    merged: dict = {}
    for line in capsys.readouterr().out.splitlines():
        merged.update(json.loads(line))
    assert merged["paths_verified"]["mxu"] == "MISMATCH vs CPU oracle"
    assert merged["paths_verified"]["vpu"] is True
    assert not [key for key in merged["paths"] if "mxu" in key]
    assert merged["paths"]["encode_vpu"] > 0 and merged["value"] > 0


def test_a_path_wrong_past_the_oracle_is_dropped(monkeypatch, capsys):
    """A path right at the oracle's two calls and wrong after: the stage's
    own check against the plain version finds it, it is never timed,
    and the line reports it."""
    real = bench.kernel_paths
    seen = []  # the calls of every instance of the path

    def paths(dev):
        good = real(dev)["mxu"]
        bad = _flip_one_byte(good)

        def step(c, x, out):
            seen.append(1)
            return (good if len(seen) <= 2 else bad)(c, x, out)
        return {"vpu": real(dev)["vpu"], "mxu": step}

    monkeypatch.setattr(bench, "kernel_paths", paths)
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    monkeypatch.setenv(bench.BYTES_ENV, str(128 << 10))
    monkeypatch.setenv(bench.CHILD_ENV, "40")
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    assert bench.child_main() == 0
    merged: dict = {}
    for line in capsys.readouterr().out.splitlines():
        merged.update(json.loads(line))
    assert merged["paths_verified"] == {
        "vpu": True, "mxu": f"MISMATCH vs plain version at {128 << 10} B "
                            f"a shard"}
    assert not [key for key in merged["paths"] if "mxu" in key]
    assert merged["paths"]["encode_vpu"] > 0 and merged["value"] > 0


def test_batched_encode_is_held_to_its_plain_version(monkeypatch):
    from seaweedfs_tpu_torch.parallel import mesh as pmesh

    good = bench.bench_batched(CPU, 64 << 10, budget_s=0.5)
    assert good["batched_encode_GBps"] > 0
    assert good["batched_encode_iters"] >= 2
    real = pmesh.batched_encode

    def flipped(m, data):
        out = real(m, data).clone()
        out[1, gf.DATA_SHARDS + 2, 5] ^= 1
        return out

    monkeypatch.setattr(pmesh, "batched_encode", flipped)
    bad = bench.bench_batched(CPU, 64 << 10, budget_s=0.5)
    assert bad == {"batched_encode_error": "RuntimeError: MISMATCH vs "
                   f"plain version at (4, {gf.DATA_SHARDS}, {64 << 10})"}


def test_crc_is_held_to_the_host_crc(monkeypatch):
    from seaweedfs_tpu_torch.ops import crc32c_cuda

    good = bench.bench_crc(CPU, 64 << 10, budget_s=0.5)
    assert good["crc_device_GBps"] > 0 and good["crc_host_GBps"] > 0
    assert good["crc_iters"] >= 2
    real = crc32c_cuda.crc32c_batch
    monkeypatch.setattr(crc32c_cuda, "crc32c_batch",
                        lambda data: real(data) ^ (torch.arange(
                            data.shape[0]) == 3).to(real(data).dtype))
    bad = bench.bench_crc(CPU, 64 << 10, budget_s=0.5)
    assert set(bad) == {"crc_error"} and "mismatch" in bad["crc_error"]


def test_no_path_verified_gives_no_rate(monkeypatch, capsys):
    real = bench.kernel_paths
    monkeypatch.setattr(bench, "kernel_paths", lambda dev: {
        name: _flip_one_byte(fn) for name, fn in real(dev).items()})
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    monkeypatch.setenv(bench.BYTES_ENV, str(128 << 10))
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    assert bench.child_main() == 0
    merged: dict = {}
    for line in capsys.readouterr().out.splitlines():
        merged.update(json.loads(line))
    assert set(merged["paths_verified"].values()) == {
        "MISMATCH vs CPU oracle"}
    assert "value" not in merged and "paths" not in merged
    assert "no kernel path passed" in merged["error"]


def test_a_failed_child_gives_zero_and_a_nonzero_exit(monkeypatch, capsys):
    monkeypatch.setattr(bench, "child_command", lambda: [
        sys.executable, "-c", "import sys; sys.exit(3)"])
    # the host stages are tested above; here their rate is a stand-in
    monkeypatch.setattr(bench, "bench_cpu", lambda: (1.5, "native-avx2"))
    monkeypatch.setattr(bench, "bench_degraded_read", lambda: {})
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    assert bench.main() == 1
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert res["metric"] == bench.METRIC
    assert res["value"] == 0.0 and res["vs_baseline"] == 0.0
    assert res["backend"] == "none"
    assert "child exited rc=3" in res["error"]
    # the host's rate stays in its own key, never in value
    assert res["cpu_baseline_GBps"] == 1.5
    assert "cpu-fallback" not in json.dumps(res)
    with open(bench.__file__) as f:
        assert "cpu-fallback" not in f.read()


def test_a_child_without_a_card_gives_zero_and_a_nonzero_exit(monkeypatch,
                                                              capsys):
    """Where no card is visible and the CPU was not asked for, the child
    refuses at start-up; the line says so and carries no rate."""
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.setattr(bench, "bench_cpu", lambda: (1.5, "native-avx2"))
    monkeypatch.setattr(bench, "bench_degraded_read", lambda: {})
    monkeypatch.setenv(bench.BUDGET_ENV, "60")
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    assert bench.main() == 1
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["value"] == 0.0 and res["backend"] == "none"
    assert "CUDA device requested" in res["error"]


@pytest.mark.gpu
def test_bench_child_on_the_card(monkeypatch, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    assert bench._verify_paths_on_device(dev) == {"vpu": True, "mxu": True}
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    monkeypatch.setenv(bench.BYTES_ENV, str(4 << 20))
    monkeypatch.setattr(bench, "_T0", time.perf_counter())
    before = bench.kernel_launches()
    assert bench.child_main() == 0
    merged: dict = {}
    for line in capsys.readouterr().out.splitlines():
        merged.update(json.loads(line))
    assert merged["backend"] == "gpu" and merged["value"] > 0
    after = bench.kernel_launches()
    assert all(after[k] > before[k] for k in after)


def test_run_benches_runs_every_tool_through_run_drivers(monkeypatch,
                                                         tmp_path):
    """chip_smoke.run_benches hands run_drivers the four tools at their
    defaults, `bench` (what `cli bench-ec` runs) first."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    seen = {}
    monkeypatch.setattr(chip_smoke, "run_drivers",
                        lambda out, card, runs: seen.update(runs=runs) or [])
    assert chip_smoke.run_benches(str(tmp_path), "a card") == []
    assert seen["runs"] == [
        ("bench", []), ("bench_ec", []),
        ("bench_ec", ["--mode", "bakeoff"]), ("bench_ec", ["--mode", "engine"]),
        ("bench_pipeline", ["1024", "16"]), ("bench_needle", ["1", "2"]),
        ("bench_needle", ["hop"])]
    for module, _ in seen["runs"]:
        assert os.path.exists(os.path.join(
            REPO, "seaweedfs_tpu_torch", "tools", module + ".py"))
