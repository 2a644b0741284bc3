"""The port's bench_needle (seaweedfs_tpu_torch/tools/bench_needle.py):
its deterministic hop accounting equals the JAX package's
tools/bench_needle.py's, row for row, and one live configuration runs on
the port's own daemons (`python -m seaweedfs_tpu_torch.cli master` and
`volume`, SWTPU_TORCH_EC_BACKEND=cpu) on free ports, driven by the
port's `benchmark` client."""

import json
import os

import pytest
import torch

from seaweedfs_tpu_torch.tools import bench_needle as port
from test_torch_tools import free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _reference():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "reference_bench_needle", os.path.join(REPO, "tools",
                                               "bench_needle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hop_accounting_equals_the_reference():
    ref = _reference()
    assert port.hop_accounting() == ref.hop_accounting()
    small = dict(n_files=300, reads=900, batch=16, depth=4, seed=3)
    assert port.hop_accounting(**small) == ref.hop_accounting(**small)


def test_interhost_accounting_equals_the_reference():
    ref = _reference()
    rows = port.interhost_accounting()
    assert rows == ref.interhost_accounting()
    assert [r["type"] for r in rows] == ["replication_fanout",
                                         "client_read", "ec_shard_gather"]
    for row in rows:
        assert row["frame"]["overhead_bytes"] < row["http"]["overhead_bytes"]
        assert row["codec_payloads_checked"] == 256
    small = dict(n_needles=300, depth=4, seed=5)
    assert port.interhost_accounting(**small) == \
        ref.interhost_accounting(**small)


def test_bench_one_on_the_ports_daemons(monkeypatch, tmp_path):
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    row = port.bench_one(1, 200, 1024, 8, base_port=free_port_block(2),
                         tmp=str(tmp_path))
    assert row["workers"] == 1 and row["n"] == 200
    assert row["write_rps"] > 0 and row["read_rps"] > 0
    json.dumps(row)
    # the two daemons, the port's CLI, logged into tmp
    logs = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.endswith(".log"))
    assert logs == ["proc0.log", "proc1.log"]
    with open(tmp_path / "proc1.log") as f:
        assert "volume server listening on" in f.read()


def test_main_hop_prints_the_accounting_lines(monkeypatch, capsys):
    """`bench_needle hop` prints the sibling-hop row and the three
    inter-host rows before its live run; the live run is replaced here."""
    monkeypatch.setattr(port, "bench_one", lambda *a, **kw: {"live": 1})
    port.main(["hop"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["hop"] == "sibling"
    assert [ln.get("type") for ln in lines[1:4]] == [
        "replication_fanout", "client_read", "ec_shard_gather"]
    assert lines[4] == {"live": 1}


@pytest.mark.parametrize("name,value", [("N", 1234), ("SIZE", 77),
                                        ("C", 5)])
def test_env_knobs_are_the_ports_own(monkeypatch, name, value):
    seen = {}

    def fake(workers, n, size, conc, **kw):
        seen.update(workers=workers, n=n, size=size, conc=conc)
        return {}

    monkeypatch.setattr(port, "bench_one", fake)
    monkeypatch.setenv(f"SWTPU_BENCH_{name}", "999999")
    monkeypatch.setenv(f"SWTPU_TORCH_BENCH_{name}", str(value))
    port.main(["1"])
    assert seen[{"N": "n", "SIZE": "size", "C": "conc"}[name]] == value
