"""The port's entry points (seaweedfs_tpu_torch/entry.py) and the
process-group helpers under them (parallel/dist.py).

dryrun_multichip(4, device="cpu") starts four gloo ranks, passes every
check of __graft_entry__.dryrun_multichip and prints its summary line;
entry() needs a card unless it is asked for the CPU, and there its step
computes what the JAX package's entry() computes. launch() reports each
rank's exit code, kills the others when one fails, and kills them all at
its time limit; init() refuses a CUDA group on a host without a card."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from seaweedfs_tpu_torch import entry
from seaweedfs_tpu_torch.parallel import dist as pdist


def test_dryrun_multichip_on_four_gloo_ranks(capfd):
    assert entry.dryrun_multichip(4, device="cpu") == 0
    out = capfd.readouterr().out
    assert ("dryrun_multichip: mesh (2, 2) ('vol','shard') ok — encoded 4 "
            "volumes, rebuilt shards (0, 11, 12, 13) via all_gather, "
            "rack-encoded 7 volumes (uneven tail)") in out


def test_entry_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so entry() would run")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        entry.dryrun_multichip(2)


def test_entry_on_cpu_matches_the_jax_entry():
    import __graft_entry__

    fn, args = entry.entry(device="cpu")
    assert args[0].device.type == "cpu" and args[0].shape == (10, 256 * 1024)
    jfn, jargs = __graft_entry__.entry()
    assert np.array_equal(np.asarray(jargs[0]), args[0].numpy())
    assert np.array_equal(np.asarray(jfn(*jargs)), fn(*args).numpy())


def test_oracle_matches_the_jax_cpu_encoder():
    from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder

    data = np.random.default_rng(3).integers(0, 256, (10, 777)
                                             ).astype(np.uint8)
    want = np.stack(CpuEncoder(use_native=False).encode(list(data)))
    assert np.array_equal(entry._oracle(data), want)


def test_launch_reports_each_rank_and_stops_the_rest_when_one_fails():
    code = ("import os, sys, time\n"
            "r = int(os.environ['RANK'])\n"
            "assert os.environ['WORLD_SIZE'] == '3'\n"
            "import seaweedfs_tpu_torch\n"
            "if r == 1: sys.exit(3)\n"
            "time.sleep(60)\n")
    codes = pdist.launch(3, ["-c", code], timeout=30)
    assert codes[1] == 3
    assert codes[0] != 0 and codes[2] != 0  # killed, not left sleeping


def test_launch_kills_every_rank_at_its_time_limit():
    with pytest.raises(TimeoutError):
        pdist.launch(2, ["-c", "import time; time.sleep(60)"], timeout=1)


def test_launch_returns_zero_codes_when_every_rank_passes():
    assert pdist.launch(2, ["-c", "pass"], timeout=30) == [0, 0]


def test_init_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        with pdist.init():
            pass
    assert not dist.is_initialized()


def test_init_makes_a_group_of_one_and_destroys_it(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(KeyError):
        with pdist.init("cpu") as dev:
            assert dev == torch.device("cpu")
            assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
            with pytest.raises(RuntimeError, match="already belongs"):
                with pdist.init("cpu"):
                    pass
            raise KeyError("the caller's error passes through")
    assert not dist.is_initialized()
