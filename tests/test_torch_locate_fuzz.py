"""Seeded randomized check of the EC stripe interval math against a
byte-wise oracle built from the layout definition.

ec/locate.py maps a logical (offset, size) to shard-local intervals
(ec_locate.go:11-83); an off-by-one here reads the wrong shard bytes on
every degraded read. The oracle lays the logical stream out row-major
into 10 columns of large then small blocks by brute force and compares
every mapped byte.

The cases of tests/test_locate_fuzz.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries. A last case holds the intervals to the JAX
package's locate_data.
"""

from __future__ import annotations

import random

from seaweedfs_tpu_torch.ec import locate
from seaweedfs_tpu_torch.ec.gf import DATA_SHARDS


def _oracle_map(dat_size: int, large: int, small: int):
    """logical offset -> (shard, shard_offset) via brute-force layout."""
    out = {}
    large_rows = 0
    pos = 0
    # rows of 10 large blocks — STRICTLY greater, matching the encoder
    # loop (ec_encoder.go:208 / pipeline.py): an exact multiple is laid
    # out entirely as small rows
    while dat_size - pos > DATA_SHARDS * large:
        for col in range(DATA_SHARDS):
            for b in range(large):
                out[pos] = (col, large_rows * large + b)
                pos += 1
        large_rows += 1
    # tail: rows of 10 small blocks (last row may be partial)
    small_row = 0
    while pos < dat_size:
        for col in range(DATA_SHARDS):
            for b in range(small):
                if pos >= dat_size:
                    return out
                out[pos] = (col, large_rows * large
                            + small_row * small + b)
                pos += 1
        small_row += 1
    return out


def test_locate_matches_bytewise_oracle():
    rng = random.Random(77)
    for large, small in ((40, 8), (64, 16), (100, 10)):
        # boundary sizes first: exact large-row multiples and the
        # within-10*small window where the reference's own read formulas
        # disagree with its encoder (see locate.n_large_block_rows)
        fixed = [DATA_SHARDS * large, 2 * DATA_SHARDS * large,
                 DATA_SHARDS * large - 1,
                 DATA_SHARDS * large - DATA_SHARDS * small + 1,
                 DATA_SHARDS * large + 1]
        sizes = fixed + [rng.randint(1, DATA_SHARDS * large * 2 + 137)
                         for _ in range(12)]
        for dat_size in sizes:
            oracle = _oracle_map(dat_size, large, small)
            for _ in range(40):
                off = rng.randint(0, dat_size - 1)
                size = rng.randint(1, dat_size - off)
                ivs = locate.locate_data(large, small, dat_size, off, size)
                assert sum(iv.size for iv in ivs) == size
                pos = off
                for iv in ivs:
                    sid, soff = iv.to_shard_and_offset(large, small)
                    for j in range(iv.size):
                        assert oracle[pos + j] == (sid, soff + j), (
                            dat_size, off, size, iv, pos + j)
                    pos += iv.size


def test_locate_equals_the_reference():
    """The same seeded (dat size, offset, size) through the JAX package's
    locate_data and the port's: the same intervals and shard offsets."""
    from seaweedfs_tpu.ec import locate as ref_locate
    rng = random.Random(78)
    for large, small in ((40, 8), (64, 16), (100, 10), (1 << 30, 1 << 20)):
        for _ in range(200):
            dat_size = rng.randint(1, DATA_SHARDS * large * 3 + 137)
            off = rng.randint(0, dat_size - 1)
            size = rng.randint(1, dat_size - off)
            got = [(vars(iv), iv.to_shard_and_offset(large, small))
                   for iv in locate.locate_data(large, small, dat_size,
                                                off, size)]
            want = [(vars(iv), iv.to_shard_and_offset(large, small))
                    for iv in ref_locate.locate_data(large, small, dat_size,
                                                     off, size)]
            assert got == want, (large, small, dat_size, off, size)
