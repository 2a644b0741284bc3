"""The port's mesh (seaweedfs_tpu_torch/parallel/mesh.py) against
seaweedfs_tpu.parallel.mesh, byte for byte.

The JAX half runs in the pytest process on jax.devices()[:n] of the
8-device virtual CPU platform (tests/conftest.py), with the Pallas kernel
K2 in interpret mode as JAX picks it off the TPU. The port half runs as n
gloo ranks, started once per world size by parallel/dist.launch: each
rank runs this file as a script, runs every scenario and writes the
global results to .npy files in tmp_path, which the test compares with
JAX's. The ranks import neither jax nor seaweedfs_tpu (each checks its
sys.modules), so this file imports JAX only inside the functions that
compute the JAX half. World size 1 runs in the test process itself;
2 and 4 ranks run in tests/test_torch_mesh_ranks.py and 8 in
tests/test_torch_mesh_eight.py, so that the test workers run them side
by side.

Scenarios: the cases of tests/test_parallel.py and of
__graft_entry__.dryrun_multichip — encode of (8, 10, 1024), a ragged rack
(V = 2 * vol + 3, n not a multiple of 512 * shard), the odd word count
n = 264 * 512 on (1, 1), full_cycle_step for two loss patterns, and
batched_verify clean, after a flipped data byte and after a flipped
parity byte.
"""

import os
import sys
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from seaweedfs_tpu_torch.parallel import dist as pdist
from seaweedfs_tpu_torch.parallel import mesh as pm

LOSSES = ((2, 5, 10, 13), (0, 11, 12, 13))
RANK_TIMEOUT_S = 120


def _inputs(vol: int, shard: int) -> dict:
    rng = np.random.default_rng(0)

    def rand(*shape):
        return rng.integers(0, 256, shape).astype(np.uint8)

    inputs = {"encode": rand(8, 10, 1024),
              "rack": rand(2 * vol + 3, 10, 512 * shard + 300)}
    if vol * shard == 1:
        inputs["odd"] = rand(1, 10, 264 * 512)
    return inputs


def run_scenarios(impl, mesh, vol: int, shard: int, to_np) -> dict:
    """Every scenario through `impl` (the port's or the JAX package's
    parallel.mesh, which share their signatures) -> name -> numpy array."""
    inputs = _inputs(vol, shard)
    out = {}
    for name in ("encode", "rack", "odd"):
        if name in inputs:
            out[name] = to_np(impl.batched_encode(mesh, inputs[name]))
    for lost in LOSSES:
        enc, reb = impl.full_cycle_step(mesh, inputs["encode"],
                                        lost_rows=lost)
        tag = "_".join(map(str, lost))
        out[f"cycle_{tag}_encoded"] = to_np(enc)
        out[f"cycle_{tag}_rebuilt"] = to_np(reb)
    shards = out["encode"]
    data_flip = np.array(shards)
    data_flip[3, 2, 100] ^= 0x5A
    parity_flip = np.array(shards)
    parity_flip[1, 12, 7] ^= 1
    for name, s in (("clean", shards), ("data_flip", data_flip),
                    ("parity_flip", parity_flip)):
        out[f"verify_{name}"] = to_np(impl.batched_verify(mesh, s))
    return out


def _port_np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _jax_results(world: int) -> dict:
    import jax

    from seaweedfs_tpu.parallel import mesh as jm

    m = jm.make_mesh(jax.devices()[:world])
    vol, shard = m.devices.shape
    return run_scenarios(jm, m, vol, shard, np.asarray)


def _rank_main(out_dir: str, init_method: str) -> None:
    with pdist.init("cpu", init_method):
        mesh = pm.make_mesh()
        vol, shard = mesh.shape
        results = run_scenarios(pm, mesh, vol, shard, _port_np)
        rank = dist.get_rank()
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "seaweedfs_tpu"))
    if leaked:
        raise RuntimeError(f"rank {rank} imported {leaked}")
    for name, arr in results.items():
        np.save(os.path.join(out_dir, f"rank{rank}_{name}.npy"), arr)


def _assert_equal(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape, name
        assert np.array_equal(got[name], arr), name
    # the scenarios are not vacuous
    assert want["verify_clean"].tolist() == [0] * 8
    assert want["verify_data_flip"][3] > 0
    assert want["verify_parity_flip"].tolist() == [0, 1] + [0] * 6
    for lost in LOSSES:
        tag = "_".join(map(str, lost))
        assert np.array_equal(want[f"cycle_{tag}_rebuilt"],
                              want[f"cycle_{tag}_encoded"][:, list(lost)])


def check_gloo_ranks(world: int, shape: tuple, tmp_path) -> None:
    """Run every scenario on `world` gloo ranks and on JAX's mesh of as
    many devices (computed meanwhile), and compare every rank's results."""
    argv = [os.path.abspath(__file__), str(tmp_path),
            "file://" + str(tmp_path / "rdzv")]
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(pdist.launch, world, argv, RANK_TIMEOUT_S)
        want = _jax_results(world)
        codes = ranks.result()
    assert codes == [0] * world
    assert pm.mesh_shape(world) == shape
    for rank in range(world):
        got = {name: np.load(tmp_path / f"rank{rank}_{name}.npy")
               for name in want}
        _assert_equal(got, want)


def test_port_mesh_of_one_rank_in_process_matches_jax(tmp_path):
    with pdist.init("cpu", "file://" + str(tmp_path / "rdzv")):
        mesh = pm.make_mesh()
        assert mesh.shape == (1, 1)
        with pytest.raises(ValueError, match="does not divide"):
            pm.make_mesh(vol_axis=2)
        got = run_scenarios(pm, mesh, 1, 1, _port_np)
    assert not dist.is_initialized()
    _assert_equal(got, _jax_results(1))


_RULE_BEYOND_8 = {9: (9, 1), 10: (5, 2), 11: (11, 1), 12: (6, 2),
                  13: (13, 1), 14: (7, 2), 15: (15, 1), 16: (8, 2)}


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_axis_rule_matches_jax(n):
    if n <= 8:
        import jax

        from seaweedfs_tpu.parallel import mesh as jm
        want = jm.make_mesh(jax.devices()[:n]).devices.shape
    else:  # beyond the 8 virtual devices: the rule written out
        want = _RULE_BEYOND_8[n]
    assert pm.mesh_shape(n) == tuple(want)


def test_mesh_axis_rule_takes_an_explicit_vol_axis():
    import jax

    from seaweedfs_tpu.parallel import mesh as jm
    want = jm.make_mesh(jax.devices()[:8], vol_axis=2).devices.shape
    assert pm.mesh_shape(8, vol_axis=2) == tuple(want) == (2, 4)


def test_rebuild_raises_before_any_collective_where_jax_does():
    """k = 10 rows do not split over a shard axis of 7: JAX's device_put
    raises ValueError; the port raises it from the mesh's shape alone,
    before it touches a process group (none exists here)."""
    import jax

    from seaweedfs_tpu.parallel import mesh as jm
    shards = np.zeros((1, 10, 512 * 7), np.uint8)
    jmesh = jm.make_mesh(jax.devices()[:7])
    assert jmesh.devices.shape == (1, 7) == pm.mesh_shape(7)
    with pytest.raises(ValueError):
        jm.batched_rebuild(jmesh, list(range(10)), shards, [10])
    assert not dist.is_initialized()
    mesh = types.SimpleNamespace(shape=(1, 7))
    with pytest.raises(ValueError, match="do not split"):
        pm.batched_rebuild(mesh, list(range(10)), shards, [10])
    with pytest.raises(ValueError, match="do not split"):
        pm.full_cycle_step(mesh, shards)


def test_pad_axis_matches_jax():
    from seaweedfs_tpu.parallel import mesh as jm
    x = np.arange(2 * 3 * 5, dtype=np.uint8).reshape(2, 3, 5)
    for axis, quantum in ((0, 3), (2, 4), (2, 5), (1, 1)):
        want = np.asarray(jm._pad_axis(x, axis, quantum))
        got = pm._pad_axis(torch.from_numpy(x), axis, quantum).numpy()
        assert np.array_equal(got, want), (axis, quantum)
    assert pm._COL_QUANTUM == jm._COL_QUANTUM


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
