"""Framing for multi-needle batch responses on the volume data plane.

One batch response carries many needle bodies. Each record is a compact
JSON meta line terminated by ``\n`` followed by exactly ``meta["size"]``
raw body bytes:

    {"fid":"3,0101f1...","status":200,"size":17,"etag":"deadbeef"}\n
    <17 raw bytes>
    {"fid":"3,0202ab...","status":404,"size":0,"error":"not found"}\n

The format streams: a reader never needs more lookahead than one meta
line plus the declared body, and bodies are never escaped or base64'd.
Shared by the volume server (encode), the worker sibling fan-out and
the client SDK / benchmark (decode), and the EC batched shard reads.

A copy of seaweedfs_tpu/util/batchframe.py in the PyTorch port.
"""

from __future__ import annotations

import json

CONTENT_TYPE = "application/x-seaweedfs-batch"

# a meta line is small; anything larger is a corrupt/hostile stream
MAX_META_LINE = 64 * 1024


def encode_record(meta: dict, body: bytes = b"") -> bytes:
    """One framed record; ``size`` is always derived from the body."""
    m = dict(meta)
    m["size"] = len(body)
    return json.dumps(m, separators=(",", ":")).encode() + b"\n" + body


class FrameParser:
    """Incremental decoder: feed() arbitrary chunks, get complete
    ``(meta, body)`` records back as they close."""

    __slots__ = ("_buf", "_meta", "_need")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._meta: dict | None = None
        self._need = 0

    def feed(self, data: bytes) -> list[tuple[dict, bytes]]:
        self._buf += data
        out: list[tuple[dict, bytes]] = []
        while True:
            if self._meta is None:
                nl = self._buf.find(b"\n")
                if nl < 0:
                    if len(self._buf) > MAX_META_LINE:
                        raise ValueError("batch meta line too long")
                    return out
                line = bytes(self._buf[:nl])
                del self._buf[:nl + 1]
                meta = json.loads(line)
                if not isinstance(meta, dict):
                    raise ValueError("batch meta is not an object")
                self._meta = meta
                self._need = int(meta.get("size", 0))
                if self._need < 0:
                    raise ValueError("negative batch body size")
            if len(self._buf) < self._need:
                return out
            body = bytes(self._buf[:self._need])
            del self._buf[:self._need]
            out.append((self._meta, body))
            self._meta = None
            self._need = 0

    @property
    def pending(self) -> bool:
        """True when a partial record is still buffered."""
        return bool(self._buf) or self._meta is not None


def parse_all(blob: bytes) -> list[tuple[dict, bytes]]:
    """Decode a complete batch payload; raises on trailing garbage."""
    p = FrameParser()
    out = p.feed(blob)
    if p.pending:
        raise ValueError("truncated batch payload")
    return out


def parse_reads_spec(spec: str) -> "list[tuple[int, int, int]]":
    """Parse the EC gather's ``sid:off:size,...`` spec — shared by the
    HTTP and frame transports of /admin/ec/shard_read so the grammar
    cannot drift between them. Raises ValueError on anything else."""
    reads = [tuple(int(x) for x in part.split(":"))
             for part in spec.split(",") if part]
    if not reads or any(len(r) != 3 for r in reads):
        raise ValueError("bad reads spec")
    return reads


def encode_shard_rows(reads, datas) -> bytes:
    """Render the batched shard-read response rows ({shard, status}
    meta + raw interval payload) — the one encoding both transports
    serve."""
    out = bytearray()
    for (sid, _off, _size), data in zip(reads, datas):
        if data is None:
            out += encode_record({"shard": sid, "status": 404,
                                  "error": "shard not found"})
        else:
            out += encode_record({"shard": sid, "status": 200}, data)
    return bytes(out)
