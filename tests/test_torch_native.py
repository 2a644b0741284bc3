"""The port's host C routines (seaweedfs_tpu_torch/native) and its host
CpuEncoder: the cases of tests/test_native_gf.py pointed at the port,
then byte parity with the JAX package's CpuEncoder (native and numpy
paths) and crc32c.

Mirrors the reference's dual-oracle pattern (ec_test.go:20-177): the same
bytes must come back whether produced by the assembly-speed path or the
table-lookup oracle.
"""

from __future__ import annotations

import numpy as np
import pytest

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
from seaweedfs_tpu_torch.native import gf256 as native_gf
from seaweedfs_tpu_torch.util.crc32c import crc32c

pytestmark = pytest.mark.skipif(
    not native_gf.available(), reason="native toolchain unavailable")


def _rand(n: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).astype(np.uint8)
            for _ in range(gf.DATA_SHARDS)]


def test_native_encode_matches_numpy_oracle():
    data = _rand(100_003)  # odd length exercises the AVX2 tail loop
    a = CpuEncoder(use_native=False).encode(list(data))
    b = CpuEncoder(use_native=True).encode(list(data))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_native_avx2_matches_scalar():
    data = _rand(65_537, seed=3)
    consts = gf.parity_matrix()
    s = native_gf.transform(consts, data, scalar=True)
    v = native_gf.transform(consts, data, scalar=False)
    assert all(np.array_equal(x, y) for x, y in zip(s, v))


def test_native_reconstruct_all_loss_patterns():
    data = _rand(4_096, seed=5)
    enc = CpuEncoder(use_native=True)
    full = enc.encode(list(data))
    # worst case: all four lost are data shards; also mixed + parity-only
    for lost in [(0, 1, 2, 3), (0, 5, 10, 13), (10, 11, 12, 13), (7,)]:
        part = [None if i in lost else full[i] for i in range(gf.TOTAL_SHARDS)]
        out = enc.reconstruct(part)
        for i in range(gf.TOTAL_SHARDS):
            assert np.array_equal(out[i], full[i]), (lost, i)


def test_native_random_matrix_agrees_with_gf_math():
    rng = np.random.default_rng(11)
    consts = rng.integers(0, 256, (3, 5)).astype(np.uint8)
    inputs = [rng.integers(0, 256, 1_000).astype(np.uint8) for _ in range(5)]
    got = native_gf.transform(consts, inputs)
    for r in range(3):
        want = np.zeros(1_000, np.uint8)
        for j in range(5):
            want ^= gf.mul_table(int(consts[r, j]))[inputs[j]]
        assert np.array_equal(got[r], want)


def test_native_crc32c_vector():
    # RFC 3720 test vector for CRC32-Castagnoli
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


# ---- parity with the JAX package ----

def _ref_encoder(use_native: bool):
    from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder as RefCpuEncoder
    return RefCpuEncoder(use_native=use_native)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_cpu_encoder_equals_the_jax_package(use_native):
    """encode, reconstruct of every loss shape, the batched transform
    and verify give the JAX package's CpuEncoder's bytes and verdicts."""
    data = _rand(10_007, seed=21)
    port, ref = CpuEncoder(use_native=use_native), _ref_encoder(use_native)
    full = port.encode(list(data))
    want = ref.encode(list(data))
    assert all(np.array_equal(x, y) for x, y in zip(full, want))
    for lost in [(0, 3, 7, 9), (1, 10), (13,), (10, 11, 12, 13)]:
        part = [None if i in lost else full[i] for i in range(gf.TOTAL_SHARDS)]
        got, exp = port.reconstruct(part), ref.reconstruct(part)
        assert all(np.array_equal(x, y) for x, y in zip(got, exp)), lost
    rng = np.random.default_rng(22)
    block = rng.integers(0, 256, (3, gf.DATA_SHARDS, 4099), dtype=np.uint8)
    coeff = gf.shard_rows([0, 3, 7, 9], [1, 2, 4, 5, 6, 8, 10, 11, 12, 13])
    assert np.array_equal(port.transform_batch(coeff, block),
                          ref.transform_batch(coeff, block))
    stored = port.encode_batch(block)
    stored[1, 12, 77] ^= 1
    assert port.verify_batch(stored).tolist() == \
        ref.verify_batch(stored).tolist() == [True, False, True]


def test_crc32c_equals_the_jax_package():
    from seaweedfs_tpu.util import crc32c as ref_crc
    from seaweedfs_tpu_torch.util import crc32c as port_crc
    rng = np.random.default_rng(23)
    for n in (0, 1, 7, 8, 9, 63, 64, 65, 4096, 100_003):
        blob = rng.bytes(n)
        assert port_crc.crc32c(blob) == ref_crc.crc32c(blob), n
        assert port_crc.crc32c(blob, 0x1234) == ref_crc.crc32c(blob, 0x1234)
        assert port_crc.checksum_value(blob) == ref_crc.checksum_value(blob)
        assert port_crc._crc32c_py(0, blob[:500]) == port_crc.crc32c(blob[:500])

