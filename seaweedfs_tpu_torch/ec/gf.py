"""GF(2^8) arithmetic and Reed-Solomon matrix construction (host side).

This is the mathematical foundation of the erasure-coding engine. The
reference (weed/storage/erasure_coding/ec_encoder.go:192) delegates GF(256)
arithmetic to klauspost/reedsolomon, whose field is generated by the
primitive polynomial x^8 + x^4 + x^3 + x^2 + 1 (0x11D) — the Backblaze
"generating polynomial 29" convention. We reproduce the same field and the
same default systematic-Vandermonde encode matrix so shards produced by
either implementation are bit-identical.

Everything here is tiny host-side numpy (tables are 256 entries, matrices at
most 14x10); the throughput-critical matmul over stripe data lives in
encoder_torch.py / ops/gf256_cuda.py.
"""

from __future__ import annotations

import functools

import numpy as np

# RS(10,4) scheme constants (reference: ec_encoder.go:16-22).
DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
# survivors a rebuild reads beyond the k it decodes from: each extra row
# is derived from the first k and compared with what was read, so one
# rotten input is found (and, with two extras, pinned) before anything
# derived from it is written (pipeline.rebuild_ec_files)
REBUILD_CHECK_ROWS = 2

# GF(2^8) reduction polynomial: x^8+x^4+x^3+x^2+1.
_POLY = 0x11D


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    """exp/log tables for the field generated by alpha=2 under _POLY."""
    exp = np.zeros(512, dtype=np.uint8)  # doubled to skip mod-255 on mul
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(256) division by zero")
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] - GF_LOG[b]) % 255])


def gf_inv(a: int) -> int:
    return gf_div(1, a)


def gf_exp(a: int, n: int) -> int:
    """a ** n in GF(256) (klauspost galExp semantics: 0**0 == 1)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


@functools.lru_cache(maxsize=512)
def mul_table(c: int) -> np.ndarray:
    """Full 256-entry multiply-by-constant table, used by the CPU encoder."""
    if c == 0:
        return np.zeros(256, dtype=np.uint8)
    out = np.zeros(256, dtype=np.uint8)
    lc = GF_LOG[c]
    xs = np.arange(1, 256)
    out[1:] = GF_EXP[lc + GF_LOG[xs]]
    return out


# ---------------------------------------------------------------------------
# Matrix algebra over GF(256) — numpy uint8 matrices.
# ---------------------------------------------------------------------------


def mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """C = A x B over GF(256). Shapes (r,k) x (k,c) -> (r,c)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    r, k = a.shape
    k2, c = b.shape
    assert k == k2, (a.shape, b.shape)
    out = np.zeros((r, c), dtype=np.uint8)
    for i in range(r):
        acc = np.zeros(c, dtype=np.uint8)
        for j in range(k):
            acc ^= mul_table(int(a[i, j]))[b[j]]
        out[i] = acc
    return out


def mat_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def mat_invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(256). Raises ValueError if singular."""
    m = np.array(m, dtype=np.uint8)
    n, n2 = m.shape
    assert n == n2, m.shape
    work = np.concatenate([m, mat_identity(n)], axis=1)
    for col in range(n):
        pivot = None
        for r in range(col, n):
            if work[r, col] != 0:
                pivot = r
                break
        if pivot is None:
            raise ValueError("singular matrix over GF(256)")
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        # Scale pivot row to make the pivot 1.
        inv = gf_inv(int(work[col, col]))
        work[col] = mul_table(inv)[work[col]]
        # Eliminate the column from every other row.
        for r in range(n):
            if r != col and work[r, col] != 0:
                work[r] ^= mul_table(int(work[r, col]))[work[col]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r, c] = r ** c over GF(256) (klauspost buildMatrix vandermonde)."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf_exp(r, c)
    return v


@functools.lru_cache(maxsize=8)
def rs_matrix(data_shards: int = DATA_SHARDS,
              total_shards: int = TOTAL_SHARDS) -> np.ndarray:
    """Systematic encode matrix, identical to klauspost/reedsolomon New(k,m).

    Vandermonde(total, data) x inverse(top square) — top k rows become the
    identity, bottom m rows are the parity coefficients. Any k rows of the
    result are linearly independent, which is what makes every 10-of-14
    subset decodable.
    """
    v = vandermonde(total_shards, data_shards)
    top_inv = mat_invert(v[:data_shards])
    m = mat_mul(v, top_inv)
    assert np.array_equal(m[:data_shards], mat_identity(data_shards))
    return m


def parity_matrix(data_shards: int = DATA_SHARDS,
                  total_shards: int = TOTAL_SHARDS) -> np.ndarray:
    """The (m, k) bottom block of rs_matrix: parity = P x data."""
    return rs_matrix(data_shards, total_shards)[data_shards:].copy()


def decode_matrix(present_rows: list[int],
                  data_shards: int = DATA_SHARDS,
                  total_shards: int = TOTAL_SHARDS) -> np.ndarray:
    """Matrix reconstructing the k data shards from k present shard rows.

    present_rows: sorted indices (into 0..total-1) of k available shards.
    Returns (k, k) M such that data = M x present_shards. This is the tiny
    host-side inversion used by Reconstruct/ReconstructData
    (reference: klauspost reedsolomon.Reconstruct via ec_encoder.go:264,
    store_ec.go:322).
    """
    assert len(present_rows) == data_shards, present_rows
    sub = rs_matrix(data_shards, total_shards)[list(present_rows)]
    return mat_invert(sub)


def shard_rows(want_rows: list[int], present_rows: list[int],
               data_shards: int = DATA_SHARDS,
               total_shards: int = TOTAL_SHARDS) -> np.ndarray:
    """Matrix producing arbitrary shard rows from k present shard rows.

    want = R x present, where R = rs_matrix[want] x decode_matrix(present).
    Used to rebuild lost shards (data or parity) in one matmul.
    """
    dm = decode_matrix(present_rows, data_shards, total_shards)
    return mat_mul(rs_matrix(data_shards, total_shards)[list(want_rows)], dm)


@functools.lru_cache(maxsize=4096)
def cached_shard_rows(want_rows: tuple, present_rows: tuple,
                      data_shards: int = DATA_SHARDS,
                      total_shards: int = TOTAL_SHARDS) -> np.ndarray:
    """Memoized shard_rows: the coefficient schedule of a repair plan.

    A degraded-read storm recovers the same (missing, survivors) shape
    for every needle interval; the Gauss-Jordan inversion is tiny but
    per-interval, so it is cached per exact row tuple. The returned
    matrix is shared — callers must treat it as read-only."""
    m = shard_rows(list(want_rows), list(present_rows),
                   data_shards, total_shards)
    m.setflags(write=False)
    return m


# ---------------------------------------------------------------------------
# Bitplane decomposition of the parity map — the GPU-kernel representation.
# ---------------------------------------------------------------------------


def bitplane_constants(coeff: np.ndarray) -> np.ndarray:
    """Expand a (m, k) GF coefficient matrix to (m, k, 8) constant bytes.

    gf_mul(c, x) == XOR_{j: bit j of x set} gf_mul(c, 1<<j), so a GF(256)
    matrix-vector product becomes pure AND/XOR over the 8 bitplanes of each
    input byte — the form the CUDA kernel evaluates.
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
    m, k = coeff.shape
    out = np.zeros((m, k, 8), dtype=np.uint8)
    for p in range(m):
        for i in range(k):
            for j in range(8):
                out[p, i, j] = gf_mul(int(coeff[p, i]), 1 << j)
    return out


def gf2_matrix(coeff: np.ndarray) -> np.ndarray:
    """Expand a (m, k) GF(256) matrix to its (8m, 8k) GF(2) bit-matrix.

    Multiplication by a GF(256) constant is linear over GF(2): output bit b
    of gf_mul(c, x) = XOR over input bits j present in gf_mul(c, 1<<j).
    The resulting binary matrix turns the whole shard transform into
    out_bits = B x in_bits (mod 2) — an integer matmul followed by a parity
    (mod 2) reduction.

    Bit order: row p*8+b is output byte p, bit b (LSB first); column i*8+j is
    input byte i, bit j.
    """
    coeff = np.asarray(coeff, dtype=np.uint8)
    m, k = coeff.shape
    bp = bitplane_constants(coeff)  # (m, k, 8) bytes
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for p in range(m):
        for i in range(k):
            for j in range(8):
                byte = int(bp[p, i, j])
                for b in range(8):
                    out[p * 8 + b, i * 8 + j] = (byte >> b) & 1
    return out
