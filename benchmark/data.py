"""What a cell stores, made from its seed: the parts laid out over the
volumes, their bytes and their cookies.

Every part is a whole `part_bytes` needle and the layout follows from
the configuration alone, so every run does the same work; the run's
seed draws the bytes, the cookies and the order of the requests. The
same seed gives the same cookies on any host,
and the same bytes on the same kind of device. The bytes are drawn on
the device the cell runs on (`torch.Generator`, one call a volume) and
kept on the host: they are what every served part is compared with.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# streams of the seed: each use draws from its own
STREAM_COOKIES, STREAM_BYTES, STREAM_CLIENT, STREAM_SAMPLE = range(4)

# bytes a needle's record may add to its data in a version-3 volume:
# header 16, data size 4, flags 1, checksum 4, timestamp 8, padding < 8
RECORD_OVERHEAD = 48
SUPER_BLOCK_BYTES = 8


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator of its own for each stream of one seed."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *stream])))


def seed64(seed: int, *stream: int) -> int:
    """A 63-bit seed for torch.Generator from one stream of a seed."""
    state = np.random.SeedSequence(
        [int(seed) & (2 ** 64 - 1), *stream]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def cookies(plans: list, seed: int) -> None:
    """Give every part its cookie, from the seed."""
    r = rng(seed, STREAM_COOKIES)
    for p in plans:
        for part in p.parts:
            part.cookie = int(r.integers(0, 2 ** 32))


@dataclass
class Part:
    vid: int
    nid: int
    cookie: int
    start: int          # where its bytes start in its volume's buffer
    size: int


@dataclass
class VolumePlan:
    vid: int
    parts: list[Part] = field(default_factory=list)
    nbytes: int = 0     # the parts' bytes, without record overhead


def plan(cfg: dict) -> list[VolumePlan]:
    """Lay whole parts of cfg["part_bytes"] over cfg["volumes"] volumes,
    one to each in turn, as a master hands out writable volumes, until
    none holds another under cfg["volume_bytes"]."""
    size = cfg["part_bytes"]
    plans = [VolumePlan(vid=cfg["first_vid"] + i)
             for i in range(cfg["volumes"])]
    per = (cfg["volume_bytes"] - SUPER_BLOCK_BYTES) \
        // (size + RECORD_OVERHEAD)
    nid = 0
    for _ in range(per):
        for p in plans:
            nid += 1
            p.parts.append(Part(vid=p.vid, nid=nid, cookie=0,
                                start=p.nbytes, size=size))
            p.nbytes += size
    return plans


def volume_bytes(seed: int, p: VolumePlan, device) -> np.ndarray:
    """The bytes of one volume's parts, drawn on `device` in one call."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed64(seed, STREAM_BYTES, p.vid))
    t = torch.empty(p.nbytes, dtype=torch.uint8, device=device)
    t.random_(0, 256, generator=g)
    return t.cpu().numpy()
