"""A plain reference of SeaweedFS's RS(10,4) erasure coding, in torch.

Written from the published description alone, with no code of the
store it checks: RS(10,4) over GF(2^8) with the field polynomial
x^8 + x^4 + x^3 + x^2 + 1 (0x11D) and klauspost/reedsolomon's
systematic Vandermonde encode matrix (Vandermonde(14, 10) times the
inverse of its top 10 rows), laid out as weed/storage/erasure_coding/
ec_encoder.go lays a volume out: the .dat is cut into rows of 10 large
blocks while more than one such row remains, then into rows of 10 small
blocks, the last one padded with zeros; shard i holds column i of every
row, its large blocks first. The .ecx holds one 16-byte record a needle,
sorted by id: the id (8 bytes), the record's offset in 8-byte units (4)
and its size (4), big-endian; a needle's record is its 16-byte header
(cookie, id, size) and a body that starts with the data's length (4)
and the data.

`decode_needle` returns a needle's data from any 10 surviving shard
files; `encode_dat` makes the 14 shards of a .dat. The GF(2^8) products
are table look-ups and XORs on `device`, so the work is exact: there is
no rounding to tolerate. Imports torch alone.
"""

from __future__ import annotations

import os

import torch

DATA_SHARDS = 10
PARITY_SHARDS = 4
TOTAL_SHARDS = DATA_SHARDS + PARITY_SHARDS
LARGE_BLOCK = 1 << 30
SMALL_BLOCK = 1 << 20
POLY = 0x11D
ECX_RECORD = 16
HEADER = 16
OFFSET_UNIT = 8


def _tables() -> tuple[list[int], list[int]]:
    """exp (doubled, 510 entries) and log tables of GF(2^8) under POLY,
    generated by 2."""
    exp, log = [0] * 510, [0] * 256
    x = 1
    for i in range(255):
        exp[i] = exp[i + 255] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return EXP[LOG[a] + LOG[b]]


def power(a: int, n: int) -> int:
    """a ** n in GF(2^8), with 0 ** 0 == 1."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return EXP[(LOG[a] * n) % 255]


def mat_mul(a: list, b: list) -> list:
    out = []
    for row in a:
        r = []
        for c in range(len(b[0])):
            acc = 0
            for k, v in enumerate(row):
                acc ^= mul(v, b[k][c])
            r.append(acc)
        out.append(r)
    return out


def invert(m: list) -> list:
    """The inverse of a square GF(2^8) matrix, by Gauss-Jordan
    elimination; raises ValueError where it is singular."""
    n = len(m)
    work = [list(row) + [int(i == j) for j in range(n)]
            for i, row in enumerate(m)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if work[r][col]), None)
        if pivot is None:
            raise ValueError("singular matrix")
        work[col], work[pivot] = work[pivot], work[col]
        inv = EXP[255 - LOG[work[col][col]]]
        work[col] = [mul(inv, v) for v in work[col]]
        for r in range(n):
            f = work[r][col]
            if r != col and f:
                work[r] = [v ^ mul(f, p) for v, p in zip(work[r], work[col])]
    return [row[n:] for row in work]


def encode_matrix() -> list:
    """The 14 x 10 systematic encode matrix: shard = M x data."""
    v = [[power(r, c) for c in range(DATA_SHARDS)]
         for r in range(TOTAL_SHARDS)]
    return mat_mul(v, invert(v[:DATA_SHARDS]))


def _mul_table(device) -> torch.Tensor:
    """(256, 256) uint8: row c holds c * x for every byte x."""
    exp = torch.tensor(EXP, dtype=torch.int64)
    log = torch.tensor(LOG, dtype=torch.int64)
    idx = log[:, None] + log[None, :]
    t = exp[idx]
    t[0, :] = 0
    t[:, 0] = 0
    return t.to(torch.uint8).to(device)


def transform(coeff: list, rows: torch.Tensor) -> torch.Tensor:
    """out[i] = XOR over j of coeff[i][j] * rows[j], for rows (n, L)
    uint8 on any device."""
    table = _mul_table(rows.device)
    idx = rows.long()
    out = torch.zeros((len(coeff), rows.shape[1]), dtype=torch.uint8,
                      device=rows.device)
    for i, crow in enumerate(coeff):
        for j, c in enumerate(crow):
            if c:
                out[i] ^= table[c][idx[j]]
    return out


def large_rows(shard_size: int, large_block: int, small_block: int) -> int:
    """Large-block rows of a volume whose shards are `shard_size` bytes:
    the encoder leaves between one and large_block / small_block small
    rows after them, so the rest is at least one small block and at most
    one large block."""
    return max(0, (shard_size - small_block) // large_block)


def encode_dat(dat: bytes, large_block: int = LARGE_BLOCK,
               small_block: int = SMALL_BLOCK, device="cpu") -> list[bytes]:
    """The 14 shard files' bytes of a .dat, as ec_encoder.go writes them."""
    m = encode_matrix()
    parity = m[DATA_SHARDS:]
    src = torch.frombuffer(bytearray(dat), dtype=torch.uint8) \
        if dat else torch.zeros(0, dtype=torch.uint8)
    shards: list[list[torch.Tensor]] = [[] for _ in range(TOTAL_SHARDS)]
    pos, remaining = 0, len(dat)

    def row(block: int) -> None:
        nonlocal pos, remaining
        take = min(block * DATA_SHARDS, max(len(dat) - pos, 0))
        buf = torch.zeros(block * DATA_SHARDS, dtype=torch.uint8)
        buf[:take] = src[pos:pos + take]
        data = buf.view(DATA_SHARDS, block).to(device)
        for i in range(DATA_SHARDS):
            shards[i].append(data[i].cpu())
        par = transform(parity, data).cpu()
        for i in range(PARITY_SHARDS):
            shards[DATA_SHARDS + i].append(par[i])
        pos += block * DATA_SHARDS
        remaining -= block * DATA_SHARDS

    while remaining > large_block * DATA_SHARDS:
        row(large_block)
    while remaining > 0:
        row(small_block)
    return [b"".join(bytes(b.numpy()) for b in s) for s in shards]


def read_ecx(ecx_path: str, needle_id: int) -> tuple[int, int]:
    """(record offset in the .dat, record size) of a needle, by binary
    search of the sorted .ecx; KeyError where it is absent or deleted."""
    with open(ecx_path, "rb") as f:
        blob = f.read()
    lo, hi = 0, len(blob) // ECX_RECORD
    while lo < hi:
        mid = (lo + hi) // 2
        rec = blob[mid * ECX_RECORD:(mid + 1) * ECX_RECORD]
        key = int.from_bytes(rec[:8], "big")
        if key < needle_id:
            lo = mid + 1
        elif key > needle_id:
            hi = mid
        else:
            offset = int.from_bytes(rec[8:12], "big") * OFFSET_UNIT
            size = int.from_bytes(rec[12:16], "big", signed=True)
            if size < 0 or offset == 0:
                raise KeyError(f"needle {needle_id:x} deleted")
            return offset, size
    raise KeyError(f"needle {needle_id:x} not in {ecx_path}")


def locate(offset: int, size: int, shard_size: int, large_block: int,
           small_block: int) -> list[tuple[int, int, int]]:
    """(shard, offset in the shard file, length) of each block piece of
    the .dat range [offset, offset + size)."""
    n_large = large_rows(shard_size, large_block, small_block)
    large_area = n_large * large_block * DATA_SHARDS
    out = []
    while size > 0:
        if offset < large_area:
            block, base, at = large_block, 0, offset
        else:
            block, base = small_block, n_large * large_block
            at = offset - large_area
        row, within = divmod(at, block * DATA_SHARDS)
        sid, inner = divmod(within, block)
        take = min(size, block - inner)
        out.append((sid, base + row * block + inner, take))
        offset += take
        size -= take
    return out


def decode_needle(shard_paths: dict, ecx_path: str, needle_id: int,
                  device="cpu", large_block: int = LARGE_BLOCK,
                  small_block: int = SMALL_BLOCK) -> bytes:
    """A needle's data bytes from surviving shard files ({shard id:
    path}, at least 10 of them): intervals on a present data shard are
    read, the others decoded from the 10 lowest present shards."""
    present = sorted(shard_paths)
    if len(present) < DATA_SHARDS:
        raise ValueError(f"{len(present)} shards: 10 are needed")
    shard_size = os.path.getsize(shard_paths[present[0]])
    offset, size = read_ecx(ecx_path, needle_id)
    rows = present[:DATA_SHARDS]
    decode = invert([encode_matrix()[r] for r in rows])
    files = {sid: open(shard_paths[sid], "rb") for sid in present}
    try:
        pieces = []
        for sid, at, n in locate(offset, HEADER + size, shard_size,
                                 large_block, small_block):
            if sid in files:
                pieces.append(os.pread(files[sid].fileno(), n, at))
                continue
            survivors = torch.stack([
                torch.frombuffer(bytearray(
                    os.pread(files[r].fileno(), n, at).ljust(n, b"\0")),
                    dtype=torch.uint8) for r in rows]).to(device)
            pieces.append(bytes(
                transform([decode[sid]], survivors)[0].cpu().numpy()))
    finally:
        for f in files.values():
            f.close()
    record = b"".join(pieces)
    got_id = int.from_bytes(record[4:12], "big")
    got_size = int.from_bytes(record[12:16], "big")
    if got_id != needle_id or got_size != size:
        raise ValueError(f"needle {needle_id:x}: the record's header names "
                         f"needle {got_id:x} of {got_size} bytes")
    n = int.from_bytes(record[HEADER:HEADER + 4], "big")
    return record[HEADER + 4:HEADER + 4 + n]
