"""Runs with the timed path broken on purpose, each of which `correct`
must come out false on: the control and the faults a cell can have.

    control    the guarantee the configuration states, broken as a
               faster program might break it: a GET serves a lost
               shard's bytes as zeros and skips the needle's CRC
    answer     K1's output altered where it is produced (one byte a row)
    served     the answer altered after the program: a GET's part has
               one byte flipped
    unchanged  K1 hands back its input's first rows: a step that
               returns its state unchanged
    half       half of the batch left out: K1 computes the first half of
               a batch of blocks (of a single block, of its bytes) and
               leaves the rest zero

The benchmark's own runs use none of them (`--fault none`). A fault is
put in after the warm-up and taken out before the check.
"""

from __future__ import annotations

import contextlib

NAMES = ("none", "control", "answer", "served", "unchanged", "half")


@contextlib.contextmanager
def applied(name: str, cell):
    if name not in NAMES:
        raise ValueError(f"unknown fault {name!r}: one of {NAMES}")
    undo: list = []
    try:
        if name != "none":
            _put(name, cell, undo)
        yield
    finally:
        for fn in reversed(undo):
            fn()


def _patch(obj, attr: str, value, undo: list) -> None:
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    undo.append(lambda: setattr(obj, attr, old))


def _put(name: str, cell, undo: list) -> None:
    from seaweedfs_tpu_torch.ec import ec_volume, encoder_torch
    transform = encoder_torch.gf256_transform
    store = cell.built.store

    if name == "answer":
        def altered(consts, x, out=None):
            y = transform(consts, x, out)
            y[:, :, 0] ^= 1
            return y
        _patch(encoder_torch, "gf256_transform", altered, undo)
    elif name == "unchanged":
        def unchanged(consts, x, out=None):
            return x[:, :consts.shape[0], :].clone()
        _patch(encoder_torch, "gf256_transform", unchanged, undo)
    elif name == "half":
        def half(consts, x, out=None):
            y = transform(consts, x, out)
            if y.shape[0] > 1:
                y[-(y.shape[0] // 2):] = 0
            else:
                y[:, :, y.shape[2] // 2:] = 0
            return y
        _patch(encoder_torch, "gf256_transform", half, undo)
    elif name == "served":
        read = store.read_needle

        def served(vid, nid, cookie=None):
            n = read(vid, nid, cookie)
            if n.data:
                n.data = bytes([n.data[0] ^ 1]) + n.data[1:]
            return n
        _patch(store, "read_needle", served, undo)
    elif name == "control":
        base = ec_volume.Needle

        class Unchecked(base):
            @classmethod
            def from_bytes(cls, blob, version=3, check_crc=True):
                return base.from_bytes(blob, version, check_crc=False)
        _patch(ec_volume, "Needle", Unchecked, undo)
        for ev in store.ec_volumes.values():
            def zeros(want_sid, offset, size):
                return b"\x00" * size, ()
            _patch(ev, "_recover_interval_src", zeros, undo)
