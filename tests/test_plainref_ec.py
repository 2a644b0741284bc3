"""The plain RS(10,4) reference (benchmark/reference/ec_rs.py) against
the port.

At small blocks on the host: the reference's 14 shards of a seeded .dat
are the port's `encode_volume` files byte for byte, over a volume with
large-block rows and small-block rows after them; its `decode_needle`
returns every needle's written bytes from the shard files that survive
each loss; and it imports torch alone."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.reference import ec_rs
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LB = 16 * 1024
SB = 1024
VID = 5
# 2 large rows (320 KiB) and 80-odd KiB of small rows after them
SIZES = (300, 3500, 90000, 12500, 4100, 121000, 700, 15500, 6200, 126000,
         2500, 18000, 8000, 11000)
LOSSES = [(0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10), (3, 7, 9, 11),
          (0, 1, 2, 3)]


@pytest.fixture(scope="module")
def volume(tmp_path_factory):
    """The encoded volume's base name and {needle id: data}."""
    d = str(tmp_path_factory.mktemp("plainref"))
    v = Volume(d, "", VID)
    rng = np.random.default_rng(2 ** 33 + 23)
    contents = {}
    for i, n in enumerate(SIZES, 1):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        v.write_needle(Needle(cookie=i * 7, id=i, data=data))
        contents[i] = data
    v.close()
    base = os.path.join(d, str(VID))
    pl.encode_volume(base, encoder=pl.get_encoder("cpu"), large_block=LB,
                     small_block=SB)
    pl.write_sorted_file_from_idx(base)
    return base, contents


def test_shards_equal_the_ports(volume):
    base, _ = volume
    with open(base + ".dat", "rb") as f:
        dat = f.read()
    assert len(dat) > 2 * LB * ec_rs.DATA_SHARDS
    shards = ec_rs.encode_dat(dat, LB, SB)
    for sid, want in enumerate(shards):
        with open(base + pl.to_ext(sid), "rb") as f:
            assert f.read() == want, sid
    assert ec_rs.large_rows(len(shards[0]), LB, SB) == 2


@pytest.mark.parametrize("lost", LOSSES)
def test_decode_every_needle_under_loss(volume, lost):
    base, contents = volume
    paths = {sid: base + pl.to_ext(sid) for sid in range(ec_rs.TOTAL_SHARDS)
             if sid not in lost}
    for nid, data in contents.items():
        got = ec_rs.decode_needle(paths, base + ".ecx", nid,
                                  large_block=LB, small_block=SB)
        assert got == data, (lost, nid)


def test_fewer_than_ten_shards_refused(volume):
    base, _ = volume
    paths = {sid: base + pl.to_ext(sid) for sid in range(9)}
    with pytest.raises(ValueError):
        ec_rs.decode_needle(paths, base + ".ecx", 1, large_block=LB,
                            small_block=SB)


def test_imports_torch_alone():
    code = ("import json, sys\n"
            "from benchmark.reference import ec_rs\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "seaweedfs_tpu",
                       "seaweedfs_tpu_torch"}

