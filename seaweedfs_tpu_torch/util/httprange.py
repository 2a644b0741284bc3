"""Shared HTTP Range header parsing for the read paths.

A copy of seaweedfs_tpu/util/httprange.py in the PyTorch port.
"""

from __future__ import annotations


class RangeError(ValueError):
    pass


def parse_range(header: str, size: int) -> tuple[int, int] | None:
    """'bytes=a-b' -> (offset, length) clipped to size, or None when the
    header is absent/not a bytes range. Raises RangeError for malformed or
    unsatisfiable ranges (callers answer 416)."""
    if not header or not header.startswith("bytes="):
        return None
    spec = header[6:].split(",")[0].strip()
    start_s, sep, end_s = spec.partition("-")
    if not sep:
        raise RangeError(f"malformed range {header!r}")
    try:
        if start_s:
            offset = int(start_s)
            end = int(end_s) if end_s else size - 1
        else:
            if not end_s:
                raise RangeError(f"malformed range {header!r}")
            offset = max(0, size - int(end_s))
            end = size - 1
    except ValueError as e:
        raise RangeError(str(e))
    end = min(end, size - 1)
    if offset >= size or offset < 0 or end < offset:
        raise RangeError(f"unsatisfiable range {header!r} for size {size}")
    return offset, end - offset + 1
