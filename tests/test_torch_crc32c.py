"""K5's port (ops/crc32c_cuda.py) against the JAX package's crc32c_batch.

Every case of tests/test_crc32c_jax.py runs the JAX function (XLA on the
CPU) and the port's plain version on the same rows and holds both to the
port's host util/crc32c. `_pick_block` and `_matrices` are held equal to
the JAX package's. A numpy model of the CUDA kernel's arithmetic
(csrc/crc32c.cu: end-aligned 256-byte segments run through the slicing-by-8
tables, blocks of 256 segments folded pairwise by the per-level operators,
their partials folded 1024 at a time and carried left to right, then the
affine constant) is held to the host CRC, so the fold's algebra is checked
on this host; change the model with the source. The kernel itself runs in
the `gpu`-marked case, which skips without a card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ops import crc32c_jax as jref
from seaweedfs_tpu_torch.ops import crc32c_cuda as k5
from seaweedfs_tpu_torch.util.crc32c import checksum_value, crc32c, masked

NS = [1, 2, 7, 64, 255, 256, 1024, 4096, 12345]


def _port(data: np.ndarray, block=None) -> np.ndarray:
    return k5.crc32c_batch(torch.from_numpy(data), block=block).numpy()


def _host(data: np.ndarray) -> np.ndarray:
    return np.array([crc32c(r.tobytes()) for r in data], np.int64)


@pytest.mark.parametrize("n", NS)
def test_matches_host_oracle(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, (4, n)).astype(np.uint8)
    want = _host(data)
    assert np.array_equal(_port(data), want)
    assert np.array_equal(np.asarray(jref.crc32c_batch(data)).astype(
        np.int64), want)


def test_edge_patterns():
    for row in (np.zeros(512, np.uint8),
                np.full(512, 0xFF, np.uint8),
                np.eye(1, 512, 0, dtype=np.uint8)[0] * 0x80):
        want = crc32c(row.tobytes())
        assert int(_port(row[None, :])[0]) == want
        assert int(np.asarray(jref.crc32c_batch(row[None, :]))[0]) == want


def test_block_choice_is_irrelevant():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (2, 2048)).astype(np.uint8)
    want = np.asarray(jref.crc32c_batch(data)).astype(np.int64)
    for blk in (1, 2, 64, 256, 2048):
        assert np.array_equal(_port(data, block=blk), want)
        assert np.array_equal(np.asarray(
            jref.crc32c_batch(data, block=blk)).astype(np.int64), want)
    assert k5._pick_block(2048) == 256
    assert k5._pick_block(12345) == 1


def test_masked_value_composes():
    data = np.arange(300, dtype=np.uint8)[None, :]
    raw = int(_port(data)[0])
    assert masked(raw) == checksum_value(data[0].tobytes())
    assert raw == int(np.asarray(jref.crc32c_batch(data))[0])


@pytest.mark.parametrize("n", [1, 255, 256, 2048, 12345, 4096 * 3])
def test_pick_block_and_matrices_equal_the_reference(n):
    assert k5._pick_block(n) == jref._pick_block(n)
    for blk in {k5._pick_block(n), 1}:
        ours, theirs = k5._matrices(n, blk), jref._matrices(n, blk)
        assert np.array_equal(ours[0], theirs[0])
        assert np.array_equal(ours[1], theirs[1])
        assert ours[2] == theirs[2]
    states = np.arange(1000, dtype=np.uint32) * np.uint32(2654435761)
    assert np.array_equal(k5._advance(states), jref._advance(states))


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        k5.crc32c_batch(torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        k5.crc32c_batch(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(ValueError):
        k5.crc32c_batch(torch.zeros((2, 0), dtype=torch.uint8))


# --- a numpy model of csrc/crc32c.cu ---------------------------------------

def _segment_state(seg: bytes, t: np.ndarray) -> int:
    """Zero-init state of one segment as a thread computes it: slicing-by-8
    over 16-byte words for a full segment, byte by byte otherwise."""
    crc = 0
    if len(seg) == k5.SEG:
        words = np.frombuffer(seg, "<u4").tolist()
        for lo, hi in zip(words[0::2], words[1::2]):
            crc ^= lo
            crc = (int(t[7][crc & 0xFF]) ^ int(t[6][(crc >> 8) & 0xFF])
                   ^ int(t[5][(crc >> 16) & 0xFF]) ^ int(t[4][crc >> 24])
                   ^ int(t[3][hi & 0xFF]) ^ int(t[2][(hi >> 8) & 0xFF])
                   ^ int(t[1][(hi >> 16) & 0xFF]) ^ int(t[0][hi >> 24]))
    else:
        for b in seg:
            crc = (crc >> 8) ^ int(t[0][(crc ^ b) & 0xFF])
    return crc


def _apply(cols: np.ndarray, v: int) -> int:
    return int(k5.apply_operator(cols, np.array([v], np.uint32))[0])


def _fold(states: list[int], ops: np.ndarray, first: int, levels: int
          ) -> int:
    st = list(states)
    for j in range(levels):
        half = 1 << j
        for i in range(0, len(st), 2 * half):
            st[i] = _apply(ops[first + j], st[i]) ^ st[i + half]
    return st[0]


def kernel_model(row: bytes) -> int:
    n = len(row)
    segs, levels = k5.fold_geometry(n)
    ops, aff = k5.fold_operators(n)
    t = k5.slicing_tables()
    padded = 1 << levels
    states = [0] * (padded - segs)
    for s in range(segs):
        end = n - (segs - 1 - s) * k5.SEG
        states.append(_segment_state(row[max(0, end - k5.SEG):end], t))
    block_levels = min(levels, 8)
    bs = 1 << block_levels
    partials = [_fold(states[i:i + bs], ops, 0, block_levels)
                for i in range(0, padded, bs)]
    chunk_levels = min(levels - block_levels, 10)
    chunk = 1 << chunk_levels
    acc = 0
    for c in range(0, len(partials), chunk):
        acc = _apply(ops[block_levels + chunk_levels], acc) ^ _fold(
            partials[c:c + chunk], ops, block_levels, chunk_levels)
    return acc ^ aff ^ 0xFFFFFFFF


@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 511, 4096, 12345,
                               256 * 300 + 17])
def test_kernel_model_matches_host(n):
    rng = np.random.default_rng([n, 5])
    row = rng.bytes(n)
    assert kernel_model(row) == crc32c(row)


def test_kernel_model_carries_chunks():
    # 2^19 segments: 2048 partials, folded 1024 at a time in two chunks
    # carried left to right (the host folds the model's partials directly,
    # so this only walks the carry, not the bytes)
    n = 256 * (1 << 19)
    segs, levels = k5.fold_geometry(n)
    assert (segs, levels) == (1 << 19, 19)
    ops, aff = k5.fold_operators(n)
    # a row that is zero but for its first and last byte: segment states
    # are zero except the first and last segment's
    t = k5.slicing_tables()
    first = _segment_state(b"\x5a" + bytes(255), t)
    last = _segment_state(bytes(255) + b"\xa5", t)
    states = [first] + [0] * (segs - 2) + [last]
    bs = 256
    partials = [0] * (segs // bs)
    partials[0] = _fold(states[:bs], ops, 0, 8)
    partials[-1] = _fold(states[-bs:], ops, 0, 8)
    acc = 0
    for c in range(0, len(partials), 1024):
        acc = _apply(ops[18], acc) ^ _fold(partials[c:c + 1024], ops, 8, 10)
    # the same row through the host CRC, in two pieces around the zeros
    crc = crc32c(b"\x5a")
    crc = crc32c(bytes(n - 2), crc)
    crc = crc32c(b"\xa5", crc)
    assert acc ^ aff ^ 0xFFFFFFFF == crc


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    for n in NS + [1 << 20]:
        data = torch.from_numpy(rng.integers(0, 256, (4, n)).astype(
            np.uint8)).to(dev)
        got = k5.crc32c_batch(data)
        want = k5.crc32c_batch_reference(data)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert got.cpu().tolist() == [crc32c(r.tobytes())
                                      for r in data.cpu().numpy()]
