"""A numpy model of the fused K4 kernel (seaweedfs_tpu_torch/ops/csrc/
gf2_bitmatrix.cu), index for index, held to the JAX package's
`CpuEncoder._apply_numpy`.

The kernel runs only on the card; its index arithmetic is checked here:
the persistent grid's tiles -> (window, column range) and each warp's
128 columns of a tile; B placed in shared memory as core matrices and
read back through the wgmma descriptor's start, leading and stride byte
offsets, with K and N permuted; which lane holds which (column, K) of an
A fragment and which (column, output bit) of an accumulator; the byte
transpose and its bank-spreading slots; the bits taken from a column
word, the zero padding of K and N; the epilogue's packing of the low
bits of sixteen sums; the staged stores and the 16-byte or byte copies
at unaligned starts and ragged tails. The wrapper's own tests are in
tests/test_torch_mxu.py; the test marked `gpu` here runs the kernel.
"""

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder as RefCpuEncoder
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ops import gf256_mxu

TILE = 512
STRIDE = TILE + 16
THREADS = 128
OWN = TILE // 4            # columns a warp owns per tile
SUB_TILES = OWN // 16      # sub-tiles of 16 columns a warp

# the 128 lanes of the warpgroup
T = np.arange(THREADS)
WARP, LANE = T >> 5, T & 31
G, TIG = LANE >> 2, LANE & 3


def plan(rows: int, k: int) -> tuple[int, int]:
    """(KS, NI): k32 steps, and instructions of N = 32 (4 output rows) per
    step, as swtpu_gf2_transform dispatches them."""
    return -(-k // 4), -(-rows // 4)


def k_meaning(kk):
    """K within a step -> (input within the step's 4, bit): K = 16 h2 +
    4 tk + e is bit tk + 4 h2 of input e."""
    kk = np.asarray(kk)
    return kk & 3, (kk >> 2 & 3) + 4 * (kk >> 4)


def n_meaning(n):
    """N within a block of 32 -> (output row within the block's 4, bit):
    n = 8 jj + 2 t + ee is bit 2 jj + ee of row t."""
    n = np.asarray(n)
    return n >> 1 & 3, 2 * (n >> 3) + (n & 1)


def place_b(bitmat: np.ndarray, rows: int, k: int) -> np.ndarray:
    """The kernel's step 1: b_s, byte idx of core idx >> 7."""
    ks, ni = plan(rows, k)
    ng = 4 * ni
    idx = np.arange(ks * 2 * ng * 128)
    core = idx >> 7
    chunk = core // ng
    grp = core - chunk * ng
    kk = idx & 15
    n = (grp & 3) * 8 + ((idx >> 4) & 7)
    e, bit = k_meaning(16 * (chunk & 1) + kk)
    inp = 4 * (chunk >> 1) + e
    t, out_bit = n_meaning(n)
    r = 4 * (grp >> 2) + t
    live = (r < rows) & (inp < k)
    out = np.zeros(idx.size, np.uint8)
    out[live] = bitmat.view(np.uint8)[(r * 8 + out_bit)[live],
                                      (inp * 8 + bit)[live]]
    return out


def desc_offsets(rows: int, k: int, s: int, q: int) -> tuple[int, int, int]:
    """(start, leading, stride) byte offsets of step s, N block q."""
    ng = 4 * plan(rows, k)[1]
    return (2 * s * ng + 4 * q) * 128, ng * 128, 128


def read_b(b_s: np.ndarray, start: int, lbo: int, sbo: int) -> np.ndarray:
    """The (32, 32) K x N operand a no-swizzle K-major descriptor reads:
    (K, N) at start + (K // 16) lbo + (N // 8) sbo + (N % 8) 16 + K % 16."""
    kk = np.arange(32)[:, None]
    nn = np.arange(32)[None, :]
    return b_s[start + (kk // 16) * lbo + (nn // 8) * sbo + (nn % 8) * 16
               + kk % 16].astype(np.int32)


def a_rows_cols():
    """For lane t, register r, byte e of an m64nNk32 int8 A fragment: the
    row (of 64) and K (of 32) it holds."""
    r = np.arange(4)[None, :, None]
    e = np.arange(4)[None, None, :]
    row = WARP[:, None, None] * 16 + G[:, None, None] + 8 * (r & 1)
    kk = TIG[:, None, None] * 4 + e + 16 * (r >> 1)
    return np.broadcast_to(row, (THREADS, 4, 4)), np.broadcast_to(
        kk, (THREADS, 4, 4))


def d_rows_cols():
    """For lane t and accumulator i of m64n32: its row (of 64) and N."""
    i = np.arange(16)[None, :]
    row = WARP[:, None] * 16 + G[:, None] + 8 * ((i >> 1) & 1)
    col = 8 * (i >> 2) + 2 * TIG[:, None] + (i & 1)
    return row, col


def row_to_column(row, sub=0):
    """The kernel's column (in the tile) of row w*16 + g + 8h of sub-tile
    `sub`: column 2g + h of warp w's sub-tile."""
    w, rem = np.divmod(row, 16)
    return w * OWN + sub * 16 + 2 * (rem % 8) + rem // 8


def slot(c):
    """Column c's 16-byte word of the transposed tile."""
    c = np.asarray(c)
    return (c & ~7) | ((c + (c >> 3)) & 7)


def transpose_4x4(r):
    """The kernel's eight __byte_perm: rows r[0..3] of 4 columns -> one
    word per column, byte i from row i."""
    def prmt(a, b, sel):
        src = [(a >> 8 * i) & 0xFF for i in range(4)] + [
            (b >> 8 * i) & 0xFF for i in range(4)]
        return sum(src[(sel >> 4 * i) & 7] << 8 * i for i in range(4))
    lo01, hi01 = prmt(r[0], r[1], 0x5140), prmt(r[0], r[1], 0x7362)
    lo23, hi23 = prmt(r[2], r[3], 0x5140), prmt(r[2], r[3], 0x7362)
    return [prmt(lo01, lo23, 0x5410), prmt(lo01, lo23, 0x7632),
            prmt(hi01, hi23, 0x5410), prmt(hi01, hi23, 0x7632)]


def pack_byte(v, h):
    """The epilogue: bits 0..7 of a column's byte from the low bits of the
    lane's accumulators v[2 jj * 2 + 2 h + ee] (d < 256 each)."""
    v = [int(x) for x in v]
    lo = (v[2 * h] + (v[2 * h + 1] << 8) + (v[2 * h + 4] << 16)
          + (v[2 * h + 5] << 24)) & 0xFFFFFFFF
    hi = ((v[2 * h + 8] << 4) + (v[2 * h + 9] << 12) + (v[2 * h + 12] << 20)
          + (v[2 * h + 13] << 28)) & 0xFFFFFFFF
    z = (lo & 0x01010101) | (hi & 0x10101010)
    return ((z * 0x01020408) & 0xFFFFFFFF) >> 24


def tiles_of(bsz: int, length: int):
    """tile -> (window, first column, columns), as load() and store()."""
    tiles = -(-length // TILE)
    for tile in range(bsz * tiles):
        bi = tile // tiles
        t0 = (tile - bi * tiles) * TILE
        yield tile, bi, t0, min(TILE, length - t0)


def model(bitmat, storage, x_off, x_sb, x_sk, bsz, k, length, rows,
          out_align=0, paths=None):
    """swtpu_gf2_transform on a flat uint8 `storage` (the bytes of x's
    allocation, taken to start 16-byte aligned): x[b, i, l] at x_off +
    b x_sb + i x_sk + l. Returns (bsz, rows, length); `paths` collects
    which copy each warp's load and store took."""
    ks, ni = plan(rows, k)
    ng = 4 * ni
    b_s = place_b(bitmat, rows, k)
    out = np.zeros(bsz * rows * length, np.uint8)
    o_sb, o_sr = rows * length, length
    # rows k .. 4 KS - 1 are never written (zero here; B is zero there)
    raw = np.zeros(max(4 * ks, ng) * STRIDE, np.uint8)
    a_row, a_k = a_rows_cols()
    d_row, d_col = d_rows_cols()
    paths = paths if paths is not None else []
    for _, bi, t0, n in tiles_of(bsz, length):
        src = x_off + bi * x_sb + t0
        dst = bi * o_sb + t0
        tr_s = np.zeros(TILE * 16, np.uint8)
        for w in range(4):
            first = w * OWN
            # load: the warp's columns of the k input rows
            if n == TILE and ((src | x_sk) & 15) == 0:
                paths.append("load16")
                for c in range(k * OWN // 16):
                    i, j = divmod(c, OWN // 16)
                    col = first + 16 * j
                    s0 = src + i * x_sk + col
                    raw[i * STRIDE + col:i * STRIDE + col + 16] = \
                        storage[s0:s0 + 16]
            else:
                paths.append("load1")
                for i in range(k):
                    hi = min(first + OWN, n)
                    if hi > first:
                        raw[i * STRIDE + first:i * STRIDE + hi] = storage[
                            src + i * x_sk + first:src + i * x_sk + hi]
            # transpose: lane l, columns first + 4 l .. + 3
            words = raw.view(np.uint32)
            for lane in range(32):
                col = first + 4 * lane
                wds = np.zeros((4, 4), np.uint32)  # [column][step]
                for s in range(ks):
                    rows4 = [int(words[((4 * s + i) * STRIDE + col) // 4])
                             for i in range(4)]
                    wds[:, s] = transpose_4x4(rows4)
                for c in range(4):
                    at = int(slot(col + c)) * 16
                    tr_s[at:at + 16] = wds[c].view(np.uint8)
        trw = tr_s.view(np.uint32).reshape(TILE, 4)
        for sub in range(SUB_TILES):
            col = WARP * OWN + sub * 16 + 2 * G
            w0, w1 = trw[slot(col)], trw[slot(col + 1)]
            regs = np.zeros((ks, THREADS, 4), np.uint32)
            sh = TIG.astype(np.uint32)
            for s in range(ks):
                regs[s] = np.stack([(w0[:, s] >> sh) & 0x01010101,
                                    (w1[:, s] >> sh) & 0x01010101,
                                    (w0[:, s] >> (sh + 4)) & 0x01010101,
                                    (w1[:, s] >> (sh + 4)) & 0x01010101],
                                   axis=1)
            d = np.zeros((ni, THREADS, 16), np.int64)
            for s in range(ks):
                # the 64 x 32 A operand the warpgroup's fragments form
                a = np.full((64, 32), -1, np.int64)
                fr = regs[s][:, :, None] >> (8 * np.arange(4)) & 0xFF
                a[a_row, a_k] = fr
                assert (a >= 0).all() and (a <= 1).all()
                for q in range(ni):
                    prod = a @ read_b(b_s, *desc_offsets(rows, k, s, q))
                    d[q] += prod[d_row, d_col]
            assert (d < 256).all()
            for q in range(ni):
                for t in range(THREADS):
                    at = (4 * q + TIG[t]) * STRIDE + col[t]
                    assert at % 2 == 0  # a 2-byte store
                    raw[at] = pack_byte(d[q][t], 0)
                    raw[at + 1] = pack_byte(d[q][t], 1)
        for w in range(4):
            first = w * OWN
            # store: the warp's columns of the output rows
            if n == TILE and (((out_align + dst) | o_sr) & 15) == 0:
                paths.append("store16")
                for c in range(rows * OWN // 16):
                    r, j = divmod(c, OWN // 16)
                    col = first + 16 * j
                    out[dst + r * o_sr + col:dst + r * o_sr + col + 16] = \
                        raw[r * STRIDE + col:r * STRIDE + col + 16]
            else:
                paths.append("store1")
                for r in range(rows):
                    hi = min(first + OWN, n)
                    if hi > first:
                        out[dst + r * o_sr + first:dst + r * o_sr + hi] = \
                            raw[r * STRIDE + first:r * STRIDE + hi]
    return out.reshape(bsz, rows, length)


def _want(coeff, x):
    return np.stack([np.stack(RefCpuEncoder(use_native=False)._apply_numpy(
        coeff, list(x[b]))) for b in range(x.shape[0])])


# -- the pieces -------------------------------------------------------------

def test_transpose_and_slots():
    """The eight __byte_perm put byte i of column c in word c from row
    i; slot() permutes inside groups of 8 columns and puts the 16-byte
    stores of 8 neighbouring lanes (one store phase, columns 4 apart) in
    8 distinct bank groups, and the two columns a quad reads in another."""
    r = [int.from_bytes(bytes([16 * i + c for c in range(4)]), "little")
         for i in range(4)]
    cols = transpose_4x4(r)
    assert [list(c.to_bytes(4, "little")) for c in cols] == [
        [16 * i + c for i in range(4)] for c in range(4)]
    assert sorted(slot(np.arange(TILE)).tolist()) == list(range(TILE))
    for w in range(4):
        for c in range(4):
            for ph in range(4):
                lanes = np.arange(8 * ph, 8 * ph + 8)
                assert sorted(slot(w * OWN + 4 * lanes + c) % 8) == list(
                    range(8))
        for sub in range(SUB_TILES):
            for h in (0, 1):
                for p in range(4):
                    cols = w * OWN + sub * 16 + 2 * np.array([2 * p, 2 * p + 1]) + h
                    assert len(set((slot(cols) % 8).tolist())) == 2


def test_epilogue_packs_the_low_bits_of_every_sum():
    """pack_byte: bit b of the byte is bit 0 of the sum of bit b, for
    sums 0..128, with no carry from the other sums' high bits."""
    r = np.random.default_rng(7)
    for _ in range(300):
        v = r.integers(0, 129, 16)
        for h in (0, 1):
            want = sum(int(v[4 * (b >> 1) + 2 * h + (b & 1)] & 1) << b
                       for b in range(8))
            assert pack_byte(v, h) == want


@pytest.mark.parametrize("which", ["A", "D"])
def test_fragments_cover_the_sub_tile_once(which):
    """Every (row, K) of A is in one lane's byte, every (row, N) of D in
    one lane's accumulator; rows map one to one onto 64 columns, a lane's
    two rows onto two neighbouring columns from an even one; K and N mean
    each (input, bit) and (output row, bit) once, and lane tig holds all
    8 bits of output row tig at both its columns."""
    a_row, a_k = a_rows_cols()
    d_row, d_col = d_rows_cols()
    for sub in range(SUB_TILES):
        cols = row_to_column(np.arange(64), sub)
        assert len(set(cols.tolist())) == 64
        # each warp's 16 rows are 16 neighbouring columns of its own 128
        assert (cols // OWN == np.arange(64) // 16).all()
        assert ((cols % OWN) // 16 == sub).all()
    lane_cols = row_to_column(a_row[:, :2, 0])
    assert (lane_cols[:, 1] == lane_cols[:, 0] + 1).all()
    assert (lane_cols[:, 0] % 2 == 0).all()
    if which == "A":
        seen = np.zeros((64, 32), int)
        np.add.at(seen, (a_row, a_k), 1)
        assert (seen == 1).all()
        e, bit = k_meaning(np.arange(32))
        assert sorted(zip(e.tolist(), bit.tolist())) == [
            (i, j) for i in range(4) for j in range(8)]
        # register r of lane tig: bit tig + 4 (r >> 1) of inputs 0..3
        e, bit = k_meaning(a_k)
        assert (e == np.arange(4)).all()
        assert (bit == TIG[:, None, None]
                + 4 * (np.arange(4)[None, :, None] >> 1)).all()
    else:
        seen = np.zeros((64, 32), int)
        np.add.at(seen, (d_row, d_col), 1)
        assert (seen == 1).all()
        t, bit = n_meaning(np.arange(32))
        assert sorted(zip(t.tolist(), bit.tolist())) == [
            (r, b) for r in range(4) for b in range(8)]
        t, bit = n_meaning(d_col)
        assert (t == TIG[:, None]).all()
        for lane in range(THREADS):
            for h in (0, 1):
                mine = (row_to_column(d_row[lane]) - lane_cols[lane, 0]) == h
                assert sorted(bit[lane][mine]) == list(range(8))


@pytest.mark.parametrize("rows,k", [(4, 10), (1, 1), (3, 13), (16, 16),
                                    (5, 4)])
def test_descriptors_read_back_the_permuted_transpose(rows, k):
    """Step s, N block q of b_s read through (start, LBO, SBO) holds, at
    (K, n), M's entry for output row 4 q + t, bit b and input 4 s + e, bit
    j as K and n mean them; zero past 8 k and 8 rows."""
    bitmat = gf.gf2_matrix(np.random.default_rng(rows * 17 + k).integers(
        0, 256, (rows, k))).astype(np.int8)
    ks, ni = plan(rows, k)
    b_s = place_b(bitmat, rows, k)
    e, j = k_meaning(np.arange(32))
    t, b = n_meaning(np.arange(32))
    for s in range(ks):
        for q in range(ni):
            got = read_b(b_s, *desc_offsets(rows, k, s, q))
            for kk in range(32):
                for n in range(32):
                    r, i = 4 * q + t[n], 4 * s + e[kk]
                    want = (bitmat[8 * r + b[n], 8 * i + j[kk]]
                            if r < rows and i < k else 0)
                    assert got[kk, n] == want


@pytest.mark.parametrize("bsz,length", [(1, 1), (3, 767), (8, 4096)])
def test_tiles_cover_every_column_once(bsz, length):
    seen = np.zeros((bsz, length), int)
    for _, bi, t0, n in tiles_of(bsz, length):
        assert t0 % TILE == 0 and 1 <= n <= TILE
        seen[bi, t0:t0 + n] += 1
    assert (seen == 1).all()


# -- the whole kernel --------------------------------------------------------

@pytest.mark.parametrize("bsz,k,length,rows,layout", [
    (2, 10, 1000, 4, "contiguous"), (3, 3, 777, 5, "contiguous"),
    (1, 1, 13, 2, "contiguous"), (5, 7, 300, 3, "contiguous"),
    (2, 16, 600, 16, "contiguous"), (3, 10, 1, 1, "contiguous"),
    (2, 13, 64 + 3, 5, "contiguous"), (1, 4, 13, 16, "contiguous"),
    (2, 1, 64 + 3, 1, "contiguous"), (2, 10, 512, 4, "contiguous"),
    (2, 10, 515, 4, "strided, rows 3 bytes off 16"),
    (1, 10, 1024, 1, "contiguous"),
    (3, 13, 525, 16, "strided, aligned rows")])
def test_kernel_model_matches_the_reference(bsz, k, length, rows, layout):
    r = np.random.default_rng(bsz * 1000 + length + k)
    coeff = r.integers(0, 256, (rows, k)).astype(np.uint8)
    bitmat = gf.gf2_matrix(coeff).astype(np.int8)
    if layout == "contiguous":
        base = r.integers(0, 256, (bsz, k, length)).astype(np.uint8)
        x, off = base, 0
    elif layout == "strided, rows 3 bytes off 16":
        base = r.integers(0, 256, (bsz, k + 4, length + 9)).astype(np.uint8)
        x, off = base[:, 1:1 + k, 3:3 + length], base.shape[2] + 3
    else:
        base = r.integers(0, 256, (bsz, 16, 1024)).astype(np.uint8)
        x, off = base[:, 2:2 + k, :length], 2 * 1024
    storage = base.reshape(-1)
    sb, sk = base.strides[0], base.strides[1]
    assert np.shares_memory(x, base) and x.strides[2] == 1
    paths = []
    got = model(bitmat, storage, off, sb, sk, bsz, k, length, rows,
                paths=paths)
    assert np.array_equal(got, _want(coeff, x))
    # one load and one store per warp (4) and tile
    tiles = bsz * -(-length // TILE)
    assert len(paths) == 8 * tiles
    whole = length // TILE
    if layout == "contiguous":
        # rows 16-byte aligned exactly when L is a multiple of 16
        assert paths.count("load16") == (4 * bsz * whole
                                         if length % 16 == 0 else 0)
    elif layout.startswith("strided, rows 3"):
        assert "load16" not in paths
    else:
        assert paths.count("load16") == 4 * bsz * whole > 0
        assert paths.count("load1") == 4 * bsz * (tiles // bsz - whole)
    if length % 16 == 0 and whole:
        assert paths.count("store16") == 4 * bsz * whole


# -- the wrapper -------------------------------------------------------------

def test_wrapper_has_only_the_fused_kernel_and_counts_nothing_on_the_cpu(
        monkeypatch):
    for gone in ("unpack", "pack", "_mm_rows", "_MM_ROW_QUANTUM",
                 "_MM_MIN_ROWS", "_kernels"):
        assert not hasattr(gf256_mxu, gone), gone
    assert hasattr(gf256_mxu, "chunks") and gf256_mxu.CHUNK_BYTES > 0
    monkeypatch.setattr(gf256_mxu, "launches", 0)
    monkeypatch.setattr(gf256_mxu, "calls", 0)
    x = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 10, 300)).astype(np.uint8))
    bitmat = gf256_mxu.device_bitmatrix(gf.parity_matrix(), "cpu")
    got = gf256_mxu.gf2_bitmatrix_transform(bitmat, x)
    assert np.array_equal(got.numpy(), _want(gf.parity_matrix(), x.numpy()))
    assert (gf256_mxu.launches, gf256_mxu.calls) == (0, 0)


@pytest.mark.gpu
def test_one_launch_without_chunks_on_the_card(monkeypatch):
    """(2, 10, 4 MiB): one launch for the call, where the plain version
    takes several chunks at the default budget; equal to the plain
    version and to K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from seaweedfs_tpu_torch.ec.encoder_torch import device_consts
    from seaweedfs_tpu_torch.ops.gf256_cuda import gf256_transform
    dev = torch.device("cuda", 0)
    coeff = gf.parity_matrix()
    x = torch.randint(0, 256, (2, 10, 4 << 20), dtype=torch.uint8,
                      device=dev,
                      generator=torch.Generator(device=dev).manual_seed(0))
    assert len(list(gf256_mxu.chunks(2, 4 << 20, 10, 4))) > 1
    monkeypatch.setattr(gf256_mxu, "launches", 0)
    monkeypatch.setattr(gf256_mxu, "calls", 0)
    bitmat = gf256_mxu.device_bitmatrix(coeff, dev)
    got = gf256_mxu.gf2_bitmatrix_transform(bitmat, x)
    torch.cuda.synchronize()
    assert (gf256_mxu.launches, gf256_mxu.calls) == (1, 1)
    assert torch.equal(got, gf256_mxu.gf2_bitmatrix_transform_reference(
        bitmat, x))
    assert torch.equal(got, gf256_transform(device_consts(coeff, dev), x))
