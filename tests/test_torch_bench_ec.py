"""The port's bench_ec (seaweedfs_tpu_torch/tools/bench_ec.py) against the
JAX package's tools/bench_ec.py: the same `--smoke` run with the same
seed, in process, gives the same deterministic report fields — bytes and
round trips of the degraded reads (the plan and the naive gather), the
engine's dispatches and preads, the bake-off's dispatches per GB and
byte identity. The port's transforms run on the plain PyTorch version
here (SWTPU_TORCH_EC_BACKEND=cpu), where its crossover is not
measured."""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEGRADED_KEYS = ("reads", "bytes_repaired", "bytes_fetched", "round_trips",
                 "intervals_fetched", "max_batch_rows",
                 "bytes_moved_per_byte_repaired")
ENGINE_KEYS = ("dispatches", "preads", "windows")
BAKEOFF_KEYS = ("dispatches_per_GB_batched", "dispatches_per_GB_perwindow",
                "byte_identical")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_ec")
    mp = pytest.MonkeyPatch()
    # one intra-op thread: the plain versions' thread pools in six xdist
    # workers would oversubscribe the host's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mp.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
        mp.syspath_prepend(REPO)
        from seaweedfs_tpu_torch.tools import bench_ec as port
        import tools.bench_ec as ref

        out = {}
        for name, mod in (("port", port), ("ref", ref)):
            path = str(tmp / f"{name}.json")
            argv = ["--smoke", "--seed", "1234", "--json", path]
            mp.setattr(sys, "argv", ["bench_ec", *argv])
            assert (mod.main(argv) if name == "port" else mod.main()) == 0
            with open(path) as f:
                out[name] = json.load(f)
        return out
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def test_degraded_accounting_equals_the_reference(reports):
    port, ref = reports["port"]["degraded"], reports["ref"]["degraded"]
    for key in ("lost_shards", "local_shards", "holders"):
        assert port[key] == ref[key]
    for mode in ("naive", "plan"):
        for key in DEGRADED_KEYS:
            assert port[mode][key] == ref[mode][key], (mode, key)
    # the smoke's own gate: the plan moves fewer bytes in fewer trips
    assert port["plan"]["bytes_fetched"] < port["naive"]["bytes_fetched"]


def test_engine_accounting_equals_the_reference(reports):
    port, ref = reports["port"]["engine"], reports["ref"]["engine"]
    for bw in port["encode"]:
        for key in ENGINE_KEYS:
            assert port["encode"][bw][key] == ref["encode"][bw][key], (
                bw, key)
    for bw in port["scrub"]:
        for key in ("dispatches", "preads", "windows", "bad_windows"):
            assert port["scrub"][bw][key] == ref["scrub"][bw][key], (bw, key)


def test_rebuild_launches_equal_the_reference(reports):
    port, ref = reports["port"]["rebuild"], reports["ref"]["rebuild"]
    for mode in ("sequential", "batched"):
        assert port[mode]["lost"] == ref[mode]["lost"]
        assert port[mode]["launches"] == ref[mode]["launches"]
        assert port[mode]["bytes_rebuilt"] == ref[mode]["bytes_rebuilt"]


def test_bakeoff_accounting_equals_the_reference(reports):
    port, ref = reports["port"]["bakeoff"], reports["ref"]["bakeoff"]
    assert (port["batch"], port["window_bytes"]) == (ref["batch"],
                                                     ref["window_bytes"])
    # the host rows by name; the port's torch row stands where the
    # reference's jax row does
    assert list(port["rows"]) == [n if n != "jax" else "torch-cpu"
                                  for n in ref["rows"]]
    for pname, rname in zip(port["rows"], ref["rows"]):
        for key in BAKEOFF_KEYS:
            assert port["rows"][pname][key] == ref["rows"][rname][key], (
                pname, key)


def test_crossover_not_measured_without_a_card(reports):
    assert reports["port"]["crossover"]["measured"] is False
    assert reports["port"]["crossover"]["default_bytes"] == 1 << 20


def test_no_card_and_no_cpu_asked_for_refuses(monkeypatch):
    """Without a card and without SWTPU_TORCH_EC_BACKEND=cpu the device
    row is not replaced by a host row: backends() raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    from seaweedfs_tpu_torch.tools import bench_ec as port
    with pytest.raises(RuntimeError, match="CUDA"):
        port.backends()


@pytest.mark.gpu
def test_bench_ec_smoke_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.delenv("SWTPU_TORCH_EC_BACKEND", raising=False)
    from seaweedfs_tpu_torch.tools import bench_ec as port
    path = str(tmp_path / "card.json")
    assert port.main(["--smoke", "--json", path]) == 0
    with open(path) as f:
        report = json.load(f)
    assert "torch-gpu" in report["bakeoff"]["rows"]
    assert report["crossover"]["measured"] is True
