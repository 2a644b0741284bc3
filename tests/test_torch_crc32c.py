"""K5's port (ops/crc32c_cuda.py) against the JAX package's crc32c_batch.

Every case of tests/test_crc32c_jax.py runs the JAX function (XLA on the
CPU) and the port's plain version on the same rows and holds both to the
port's host util/crc32c. `_pick_block` and `_matrices` are held equal to
the JAX package's. A numpy model of the CUDA kernel's arithmetic
(csrc/crc32c.cu: spans aligned to the row's end, each run by slicing-by-4
through the bank-private table image at the addresses the kernel computes,
a head and tail through table 0 off a 16-byte boundary; tiles of 1024
slots walked by a persistent grid; lane and warp operators and XORs
across lanes and warps; stage 2's carry of a long row's tile states 32 at
a time; then the affine constant) is held to the host CRC, so the
geometry and the fold's algebra are checked on this host; change the
model with the source. The host helpers it reads (table layout, spans,
tiles, the span the wrapper picks, the fold operators) have tests of
their own. The kernel itself runs in the `gpu`-marked case, which skips
without a card.
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
    # the kernel's entry takes CUDA tensors only; the wrapper sends a CPU
    # tensor to the plain version
    with pytest.raises(ValueError):
        k5.launch_kernel(torch.zeros((2, 4), dtype=torch.uint8))
    # no row limit: the persistent grid walks any number of tiles (the
    # kernel before it took at most 65,535 rows, its gridDim.y)
    rows = np.random.default_rng(4).integers(0, 256, (65537, 3),
                                             dtype=np.uint8)
    assert np.array_equal(_port(rows), _host(rows))
    assert k5.tile_count(65537, 3, 64) == 65


# --- a numpy model of csrc/crc32c.cu ---------------------------------------

SMS = 132  # an H100's SMs: the persistent grid's blocks
TABLE_BYTES = 256 * 128  # one slicing-by-4 table of the image


def _look(image: np.ndarray, table: int, off: int) -> int:
    return int(image[(table * TABLE_BYTES + off) >> 2])


def _step4(c: int, lane: int, image: np.ndarray) -> int:
    return (_look(image, 3, k5.entry_offset(c, 0, lane))
            ^ _look(image, 2, k5.entry_offset(c, 1, lane))
            ^ _look(image, 1, k5.entry_offset(c, 2, lane))
            ^ _look(image, 0, k5.entry_offset(c, 3, lane)))


def _step1(crc: int, b: int, lane: int, image: np.ndarray) -> int:
    return (crc >> 8) ^ _look(image, 0, k5.entry_offset(crc ^ b, 0, lane))


def _span_state(seg: bytes, addr: int, span: int, lane: int,
                image: np.ndarray) -> int:
    """Zero-init state of one span as thread `lane` computes it: a full
    span at a 16-byte boundary by slicing-by-4 over its words, any other
    through a head to the boundary and a tail through table 0, 16-byte
    words between."""
    head = 0 if len(seg) == span and addr % 16 == 0 else min(
        (16 - addr % 16) % 16, len(seg))
    crc = 0
    for b in seg[:head]:
        crc = _step1(crc, b, lane, image)
    words = (len(seg) - head) // 16
    for w in np.frombuffer(seg[head:head + 16 * words], "<u4").tolist():
        crc = _step4(crc ^ w, lane, image)
    for b in seg[head + 16 * words:]:
        crc = _step1(crc, b, lane, image)
    return crc


def _woven_states(region: bytes, image: np.ndarray) -> np.ndarray:
    """The 32 lane states of a warp's region in the woven layout: lane l
    runs units l, l + 32, ... of 4 bytes through the woven tables, which
    advance each unit's state over the 31 units after it (the region's
    bytes before its row are zeros, as the kernel's guarded loads read
    them)."""
    words = np.frombuffer(region, "<u4").reshape(-1, 32)  # [unit, lane]
    states = np.zeros(32, np.uint32)
    for lane in range(32):
        crc = 0
        for w in words[:, lane].tolist():
            crc = _step4(crc ^ w, lane, image)
        states[lane] = crc
    return states


def _apply_each(cols: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Operator i (its 32 columns, cols[i]) applied to state v[i]."""
    v = np.asarray(v, np.uint32)
    out = np.zeros_like(v)
    for b in range(32):
        out ^= np.where((v >> np.uint32(b)) & 1, cols[:, b], np.uint32(0))
    return out


def _xor_groups(v: np.ndarray, g: int) -> np.ndarray:
    """Each aligned group of g lanes XORed together (the shuffles)."""
    return np.bitwise_xor.reduce(v.reshape(-1, g), axis=1)


def _fold_tile(states: np.ndarray, levels: int, span: int,
               woven: int = 0) -> np.ndarray:
    """A tile's 1024 states folded as the kernel folds them: each lane's
    operator and the XOR of its row's lanes in a warp, then past 32 slots
    each warp state's operator and the XOR of its row's warps. Returns one
    state for each row of the tile (one for a piece of a longer row)."""
    f = k5.fold_tables(span, woven)
    lane = np.arange(k5.TILE) % 32
    g1 = min(1 << levels, 32)
    v = _xor_groups(_apply_each(f[0][(g1 - 1) - (lane & (g1 - 1))],
                                states), g1)
    if levels <= 5:
        return v
    w = np.arange(32)
    g2 = min(1 << (levels - 5), 32)
    return _xor_groups(_apply_each(f[1][(g2 - 1) - (w & (g2 - 1))], v), g2)


def _carry(partials: np.ndarray, span: int) -> int:
    """Stage 2: a row's tile states folded 32 at a time (or all of them,
    when fewer), chunks carried left to right."""
    f = k5.fold_tables(span)
    g = min(len(partials), 32)
    lane = np.arange(g)
    acc = 0
    for c in range(0, len(partials), 32):
        chunk = int(np.bitwise_xor.reduce(_apply_each(
            f[2][(g - 1) - lane], partials[c:c + g])))
        acc = int(k5.apply_operator(f[2][32], np.array([acc]))[0]) ^ chunk
    return acc


def _tile_states(rows: list[bytes], tile: int, span: int, offset: int,
                 stride: int, woven: bool) -> np.ndarray:
    """The 1024 states of a tile: each slot's span, or woven each warp's
    region."""
    n = len(rows[0])
    m, levels = k5.span_layout(n, span)
    row, s = k5.tile_slots(tile, n, span)
    states = np.zeros(k5.TILE, np.uint32)
    if woven:
        image = k5.table_image(woven=True)
        for w in range(32):
            r, s0 = int(row[32 * w]), int(s[32 * w])
            first = n - (m - s0) * span
            if r >= len(rows) or first + 32 * span <= 0:
                continue
            assert (offset + r * stride + max(first, 0)) % k5.SLICE == 0
            region = (bytes(max(-first, 0))
                      + rows[r][max(first, 0):first + 32 * span])
            states[32 * w:32 * w + 32] = _woven_states(region, image)
        return states
    image = k5.table_image()
    begin, end = k5.span_bounds(n, span)
    for i in np.flatnonzero((row < len(rows)) & (s >= 0)):
        b, e = int(begin[s[i]]), int(end[s[i]])
        states[i] = _span_state(rows[row[i]][b:e],
                                offset + row[i] * stride + b, span, i % 32,
                                image)
    return states


def kernel_model(rows: list[bytes], span: int, offset: int = 0,
                 stride: int | None = None) -> list[int]:
    """The CRCs csrc/crc32c.cu computes for equal rows, row r at byte
    offset + r * stride (stride n by default) from a 16-byte boundary: the
    layout the wrapper picks (woven_layout), the persistent grid's walk
    over tiles, each tile's states and folds, stage 2's carry and the
    affine constant."""
    n = len(rows[0])
    stride = n if stride is None else stride
    _, levels = k5.span_layout(n, span)
    woven = k5.woven_layout(offset, stride, len(rows), n, span)
    tiles = k5.tile_count(len(rows), n, span)
    grid = min(tiles, SMS)
    walked = [t for b in range(grid) for t in range(b, tiles, grid)]
    assert sorted(walked) == list(range(tiles))
    out: dict[int, int] = {}
    partial = np.zeros(tiles, np.uint32)
    for tile in walked:
        folded = _fold_tile(_tile_states(rows, tile, span, offset, stride,
                                         woven),
                            levels, span, k5.SLICE if woven else 0)
        if levels > 10:
            partial[tile] = folded[0]
            continue
        for j, r in enumerate(range(tile * len(folded),
                                    (tile + 1) * len(folded))):
            if r < len(rows):
                out[r] = int(folded[j])
    if levels > 10:
        q = 1 << (levels - 10)
        out = {r: _carry(partial[r * q:(r + 1) * q], span)
               for r in range(len(rows))}
    fin = k5.affine(n) ^ 0xFFFFFFFF
    return [out[r] ^ fin for r in range(len(rows))]


@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 511, 4096, 12345,
                               256 * 300 + 17])
def test_kernel_model_matches_host(n):
    # three rows, so a tile holds several rows and rows after the first
    # start off a 16-byte boundary when n is not a multiple of 16; every
    # span size, and the one the wrapper picks for these rows
    rng = np.random.default_rng([n, 5])
    rows = [rng.bytes(n) for _ in range(3)]
    want = [crc32c(r) for r in rows]
    for span in k5.SPANS:
        assert kernel_model(rows, span) == want, span
    assert k5.pick_span(3, n, SMS) in k5.SPANS


@pytest.mark.parametrize("offset", [1, 5, 15])
def test_kernel_model_takes_rows_off_a_boundary(offset):
    # rows that start 1, 5 and 15 bytes past a 16-byte boundary, as a
    # strided view gives them: a head through table 0, then 16-byte words
    rng = np.random.default_rng([offset, 6])
    rows = [rng.bytes(4096) for _ in range(3)]
    assert kernel_model(rows, 128, offset=offset, stride=5000) == [
        crc32c(r) for r in rows]


def test_kernel_model_carries_chunks():
    # one 128 MiB row in 512-byte spans, woven: 2^18 spans, 256 tiles of
    # 1024, folded by stage 2 32 at a time in 8 chunks carried left to
    # right (the row is zero but for its first and last byte, so only the
    # first warp of the first tile and the last warp of the last tile have
    # a state; the model runs those two regions and folds and stage 2 over
    # every tile)
    n, span = 128 << 20, 512
    assert k5.span_layout(n, span) == (1 << 18, 18)
    assert k5.tile_count(1, n, span) == 256
    assert k5.pick_span(1, n, SMS) == span
    assert k5.woven_layout(0, n, 1, n, span)
    image = k5.table_image(woven=True)
    region = 32 * span
    partial = np.zeros(256, np.uint32)
    for tile, data, warp in ((0, b"\x5a" + bytes(region - 1), 0),
                             (255, bytes(region - 1) + b"\xa5", 31)):
        states = np.zeros(k5.TILE, np.uint32)
        states[32 * warp:32 * warp + 32] = _woven_states(data, image)
        partial[tile] = _fold_tile(states, 18, span, k5.SLICE)[0]
    got = _carry(partial, span) ^ k5.affine(n) ^ 0xFFFFFFFF
    # the same row through the host CRC, in two pieces around the zeros
    crc = crc32c(b"\x5a")
    crc = crc32c(bytes(n - 2), crc)
    crc = crc32c(b"\xa5", crc)
    assert got == crc


@pytest.mark.parametrize("n", [4096, 4100, 12344, 70000])
def test_kernel_model_weaves(n):
    # rows whose warps' regions are woven at some span sizes: whole
    # regions (4096), regions that start before the row, in the padding
    # and the short first span (4100, 12344), and stage 2 (70000 in 64-byte
    # spans: 1,094 spans, two tiles a row); each span size, woven where
    # woven_layout allows it and contiguous where it does not
    rng = np.random.default_rng([n, 7])
    rows = [rng.bytes(n) for _ in range(3)]
    want = [crc32c(r) for r in rows]
    layouts = set()
    for span in k5.SPANS:
        layouts.add(k5.woven_layout(0, n, 3, n, span))
        assert kernel_model(rows, span) == want, span
    assert True in layouts


# --- the host helpers the kernel's launch rests on ---------------------------

@pytest.mark.parametrize("slice_", [4, 8])
def test_table_image_is_bank_private(slice_):
    copies = 128 // slice_
    image = k5.table_image(slice_)
    t = k5.slicing_tables()[:slice_]
    assert image.nbytes == 128 << 10
    # every lane's copy of every table equals slicing_tables()
    for lane in range(32):
        copy = image.reshape(slice_, 256, copies)[:, :, lane % copies]
        assert np.array_equal(copy, t)
    # the kernel's address of byte j of c in table k for each lane: the
    # entry of that byte, in a bank of the lane's own (slicing-by-4: bank
    # = lane; the 16 copies of slicing-by-8: two lanes to a bank)
    # the woven layout's image: the same layout of woven_tables, each
    # entry the slicing table's advanced over the 31 units of the other
    # lanes
    woven = k5.table_image(slice_, woven=True)
    gap = k5._advance_by(31 * slice_)
    assert np.array_equal(woven.reshape(slice_, 256, copies)[:, :, 5],
                          k5.apply_operator(gap, t))
    rng = np.random.default_rng(slice_)
    for c in rng.integers(0, 2**32, 64, dtype=np.uint64).tolist():
        for j in range(4):
            for k in range(slice_):
                for lane in range(32):
                    word = (k * (256 << (7 if slice_ == 4 else 6))
                            + k5.entry_offset(c, j, lane, slice_)) >> 2
                    assert word % 32 == lane % copies + (
                        0 if slice_ == 4 else 16 * ((c >> 8 * j) & 1))
                    assert image[word] == t[k][(c >> 8 * j) & 0xFF]


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 511, 512, 513, 4096,
                               12345, 1 << 20, 128 << 20])
def test_spans_and_tiles_cover_every_byte_once(n):
    for span in k5.SPANS:
        begin, end = k5.span_bounds(n, span)
        m, levels = k5.span_layout(n, span)
        assert len(begin) == m and (1 << levels) >= m > (1 << levels) // 2
        assert begin[0] == 0 and end[-1] == n
        assert np.array_equal(begin[1:], end[:-1])
        assert np.all(end[1:] - begin[1:] == span)
        assert 1 <= end[0] - begin[0] <= span
        # every (row, span) of 3 rows in exactly one slot of one tile
        rows = 3
        hits = np.zeros((rows, m), np.int64)
        for tile in range(k5.tile_count(rows, n, span)):
            row, s = k5.tile_slots(tile, n, span)
            keep = (row < rows) & (s >= 0)
            np.add.at(hits, (row[keep], s[keep]), 1)
        assert np.all(hits == 1)


def test_pick_span():
    # bench.py's shape fills the H100's 132 SMs in one wave of 512-byte
    # spans; shorter rows take shorter spans, so their tiles spread over
    # the grid
    assert k5.pick_span(64, 1 << 20, SMS) == 512
    assert k5.pick_span(4096, 4096, SMS) == 128
    assert k5.pick_span(65537, 16, SMS) == 64
    assert k5.pick_span(1, 128 << 20, SMS) == 512
    assert k5.tile_count(64, 1 << 20, 512) == 128
    assert k5.tile_count(4096, 4096, 128) == 128
    assert k5.tile_count(1, 128 << 20, 512) == 256


@pytest.mark.parametrize("span", k5.SPANS)
def test_fold_tables(span):
    f = k5.fold_tables(span)
    step = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    ident = step.copy()
    for _ in range(span):
        step = k5._advance(step)
    assert np.array_equal(f[0, 1], step)
    for t in range(3):
        assert np.array_equal(f[t, 0], ident)
        for k in range(32):
            assert np.array_equal(f[t, k + 1],
                                  k5.apply_operator(f[t, 1], f[t, k]))
        if t < 2:
            assert np.array_equal(f[t + 1, 1], f[t, 32])
    words = k5.fold_words(span)
    assert words.shape == (3 * 1024 + 32,)
    assert words[5 * 32 + 7] == f[0, 7, 5]
    assert words[1024 + 31 * 32 + 2] == f[1, 2, 31]
    assert np.array_equal(words[3072:], f[2, 32])
    # woven, the lane operators undo the advance over the 31 units past a
    # lane's last one, less the units of the lanes after it
    for unit in (4, 8):
        w = k5.fold_tables(span, unit)
        assert np.array_equal(w[1:], f[1:])
        for k in range(32):
            assert np.array_equal(k5.apply_operator(
                k5._advance_by(unit * (31 - k)), w[0, k]), ident)
    # the affine constant: A8^n(0xFFFFFFFF), as _matrices gives it
    for n in (1, 255, 4096, 12345):
        assert k5.affine(n) == k5._matrices(n, k5._pick_block(n))[2]


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    shapes = [(4, n) for n in NS + [1 << 20]] + [
        (4096, 4096), (65537, 16)] + [(3, s + d) for s in k5.SPANS
                                       for d in (-1, 1)]
    for rows, n in shapes:
        data = torch.from_numpy(rng.integers(0, 256, (rows, n)).astype(
            np.uint8)).to(dev)
        # rows one byte off their boundary where the plain version's
        # one-byte blocks stay few (its PowMat grows with n)
        for x in (data, data[:, 1:]) if 1 < n <= 1 << 16 else (data,):
            got = k5.crc32c_batch(x)
            want = k5.crc32c_batch_reference(x)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            assert got.cpu().tolist() == [crc32c(r.tobytes())
                                          for r in x.cpu().numpy()]
