"""The yardstick's arithmetic: the card's peaks, the bytes a GF(256)
transform must move, and the kernel names the device trace is read by.

A frozen copy of the bytes-per-data-byte and plausibility arithmetic of
`seaweedfs_tpu_torch/tools/bench.py`, kept under the benchmark so that a
change to the program cannot move the yardstick it is measured with.
"""

from __future__ import annotations

# NVIDIA H100 80GB HBM3 (SXM) data sheet, at its full 700 W power limit.
# A card set below it runs slower: the harness prints its power limit
# beside every share of this peak.
HBM_BYTES_PER_S = 3.35e12
HBM_BOUND_GBPS = HBM_BYTES_PER_S / 1e9

# The bytes each rate's work must move through HBM for every data byte
# it is credited with (each input read once, each output written once):
# a transform step of RS(10,4) reads 10 rows and writes 4, in encode as
# in the 4-lost rebuild; a batched encode reads 10 rows and writes the
# 14 of the full shard set; a CRC reads its rows.
BYTES_PER_DATA_BYTE = {"encode_GBps": 14 / 10, "rebuild4_GBps": 14 / 10,
                       "batched_encode_GBps": 24 / 10,
                       "crc_device_GBps": 1.0}

# The kernel K1 of the port (ops/csrc/gf256_transform.cu), as its name
# stands in a device trace: `gf256_transform_kernel<rows>(...)`.
K1_KERNEL = "gf256_transform_kernel"


class ImplausibleResult(Exception):
    pass


def ceiling_gbps(key: str) -> float:
    """The highest data rate under `key` the card's HBM rate allows."""
    return HBM_BOUND_GBPS / BYTES_PER_DATA_BYTE[key]


def check_plausible(key: str, gbs: float) -> None:
    """Raise ImplausibleResult where the bytes a data rate under `key`
    moves (BYTES_PER_DATA_BYTE) would exceed the card's HBM rate."""
    if gbs > ceiling_gbps(key):
        raise ImplausibleResult(
            f"{key} {gbs:.0f} GB/s moves "
            f"{gbs * BYTES_PER_DATA_BYTE[key]:.0f} GB/s, above the "
            f"{HBM_BOUND_GBPS:.0f} GB/s HBM ceiling")


def transform_bytes(k: int, rows: int, length: int) -> int:
    """HBM bytes of one GF(256) transform of k rows of `length` bytes
    into `rows` rows: every input byte read once and every output byte
    written once."""
    return (k + rows) * length


def bound_seconds(nbytes: float) -> float:
    """The least time the card can take to move `nbytes` through HBM."""
    return nbytes / HBM_BYTES_PER_S


def roofline_share(nbytes: float, kernel_seconds: float) -> float | None:
    """bound / kernel time, in percent; None where no kernel time was
    read. Never clamped: a share over 100 means the bytes are counted
    too high or the time leaves out part of the work."""
    if kernel_seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * bound_seconds(nbytes) / kernel_seconds
