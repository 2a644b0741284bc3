"""Seeded randomized check of the chunk-overlay algebra against a
byte-wise oracle.

filechunks.py resolves overlapping chunk writes by mtime
(filechunks.go:121-222 NonOverlappingVisibleIntervals); a bug here
silently corrupts every filer read. The oracle paints (chunk id,
within-chunk offset) onto a byte canvas in mtime order and compares the
winner per byte with the intervals and ranged views the library
produces, across 300 random overlap patterns.

The cases of tests/test_filechunks_fuzz.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries.
"""

from __future__ import annotations

import random

from seaweedfs_tpu_torch.filer.filechunks import (FileChunk,
                                            non_overlapping_visible_intervals,
                                            view_from_chunks)


def _paint(chunks, size):
    canvas = [None] * size
    for c in sorted(chunks, key=lambda c: c.mtime):
        for b in range(c.offset, min(c.offset + c.size, size)):
            # (which chunk, which byte OF that chunk) — position matters:
            # an interval pointing at the right chunk but the wrong
            # chunk_offset still serves garbage
            canvas[b] = (c.file_id, b - c.offset)
    return canvas


def test_overlay_matches_bytewise_oracle():
    rng = random.Random(1234)
    for case in range(300):
        chunks = []
        for i in range(rng.randint(1, 12)):
            off = rng.randint(0, 400)
            size = rng.randint(1, 200)
            chunks.append(FileChunk(
                file_id=f"c{case}_{i}", offset=off, size=size,
                mtime=i + 1))  # strictly increasing like real overwrites
        total = max(c.offset + c.size for c in chunks)
        canvas = _paint(chunks, total)

        visibles = non_overlapping_visible_intervals(chunks)
        pos = 0
        got = [None] * total
        for v in visibles:
            assert 0 <= v.start < v.stop, (case, v)
            assert v.start >= pos, f"case {case}: unsorted/overlapping"
            pos = v.stop
            for b in range(v.start, v.stop):
                got[b] = (v.file_id, v.chunk_offset + (b - v.start))
        assert got == canvas, f"case {case}: overlay diverges from oracle"

        # ranged views must agree with the same oracle slice
        for _ in range(5):
            off = rng.randint(0, total - 1)
            ln = rng.randint(1, total - off)
            view = [None] * ln
            for cv in view_from_chunks(chunks, off, ln):
                assert off <= cv.logic_offset \
                    and cv.logic_offset + cv.size <= off + ln, (case, cv)
                for j in range(cv.size):
                    view[cv.logic_offset - off + j] = \
                        (cv.file_id, cv.offset + j)
            assert view == canvas[off:off + ln], \
                f"case {case}: ranged view diverges at [{off},{off+ln})"
