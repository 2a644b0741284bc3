"""`python -m seaweedfs_tpu_torch.cli bench-ec` on the CPU, end to end:
chip_smoke.py's phase 17 as it rehearses here. Apart from
tests/test_torch_bench.py so that each file stays short under xdist:
this one run starts three processes and times every stage."""

import os

import pytest
import torch

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


def test_cli_bench_ec_on_the_cpu_prints_the_references_metric(monkeypatch):
    """`python -m seaweedfs_tpu_torch.cli bench-ec` under
    SWTPU_TORCH_EC_BACKEND=cpu at one tiny stage: one stdout line, exit
    0, both paths verified, every rate set and no process importing jax
    (chip_smoke's phase 17 as it rehearses on the CPU); its metric is
    the one the JAX package's bench.py prints."""
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke
    run = chip_smoke.phase_bench(on_card=False, bench_bytes=128 << 10)
    with open(os.path.join(REPO, "bench.py")) as f:
        assert f'"metric": "{run["result"]["metric"]}"' in f.read()
    assert run["launches"] == {"gf256_transform": 0,
                               "gf256_stacked_transform": 0,
                               "gf2_bitmatrix_transform": 0,
                               "crc32c_batch": 0}
