"""EC end-to-end oracle: the reference ec_test.go pattern.

Build a real volume of random needles, stripe it to 14 shard files, then
prove every needle reads back bit-identically (a) through direct stripe
math and (b) with shards destroyed, through on-the-fly reconstruction.
Then rebuild the missing shard files and compare byte-for-byte.

The cases of tests/test_ec_pipeline.py pointed at the port
(seaweedfs_tpu_torch): its modules, its servers and its own
registries. Two cases are adapted: test_ec_backend_env_override
reads SWTPU_TORCH_EC_BACKEND (gpu in place of the reference's tpu), and
test_overlapped_pipeline_error_propagates forces the threaded path that
the port takes only for a CUDA encoder.
"""

import hashlib
import itertools
import os
import random

import numpy as np
import pytest

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume, NotFoundError
from seaweedfs_tpu_torch.ec.locate import locate_data, shard_file_size
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

# Small geometry so tests exercise both large and small block areas fast.
LB = 16 * 1024   # large block
SB = 1024        # small block


@pytest.fixture(scope="module")
def ec_fixture(tmp_path_factory):
    """A volume with ~200 needles striped into 14 shards."""
    d = str(tmp_path_factory.mktemp("ecvol"))
    v = Volume(d, "", 5)
    rng = random.Random(11)
    contents = {}
    for i in range(1, 201):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 4096)))
        v.write_needle(Needle(cookie=i ^ 0x5A, id=i, data=data))
        contents[i] = data
    # tombstone a few
    for i in (17, 99):
        v.delete_needle(Needle(cookie=i ^ 0x5A, id=i))
        del contents[i]
    v.close()

    base = os.path.join(d, "5")
    enc = pl.get_encoder("cpu")
    pl.write_ec_files(base, encoder=enc, large_block=LB, small_block=SB,
                      buffer_size=SB)
    pl.write_sorted_file_from_idx(base)
    return d, base, contents


def test_shard_files_created(ec_fixture):
    d, base, _ = ec_fixture
    dat_size = os.path.getsize(base + ".dat")
    want = shard_file_size(dat_size, LB, SB)
    for i in range(14):
        assert os.path.getsize(base + pl.to_ext(i)) == want, i


def test_locate_data_unit():
    # mirrors TestLocateData (ec_test.go:187): intervals tile the request
    dat_size = 2 * LB * 10 + 3 * SB * 10 + 100
    for off, size in [(0, 1), (LB - 1, 2), (2 * LB * 10 - 1, 2),
                      (2 * LB * 10 + 5, SB * 3), (0, dat_size)]:
        ivs = locate_data(LB, SB, dat_size, off, size)
        assert sum(iv.size for iv in ivs) == size
        # re-read through shard mapping must cover contiguous logical range
        total = 0
        for iv in ivs:
            sid, soff = iv.to_shard_and_offset(LB, SB)
            assert 0 <= sid < 10
            assert soff >= 0
            total += iv.size
        assert total == size


def test_direct_reads_match(ec_fixture):
    d, base, contents = ec_fixture
    ev = EcVolume(d, "", 5, large_block=LB, small_block=SB,
                  encoder=pl.get_encoder("cpu"))
    for nid, data in contents.items():
        n = ev.read_needle(nid, cookie=nid ^ 0x5A)
        assert n.data == data, nid
    for nid in (17, 99):
        with pytest.raises(NotFoundError):
            ev.read_needle(nid)
    ev.close()


def test_degraded_reads_all_loss_patterns(ec_fixture, tmp_path):
    """Read through reconstruction with 4 shards gone (multiple patterns)."""
    d, base, contents = ec_fixture
    sample = dict(itertools.islice(contents.items(), 25))
    for missing in [(0, 1, 2, 3), (10, 11, 12, 13), (0, 5, 9, 12)]:
        ev = EcVolume(d, "", 5, large_block=LB, small_block=SB,
                      encoder=pl.get_encoder("cpu"))
        for sid in missing:
            ev.shards.pop(sid).close()
        for nid, data in sample.items():
            n = ev.read_needle(nid)
            assert n.data == data, (missing, nid)
        ev.close()


def test_rebuild_missing_shards(ec_fixture, tmp_path):
    d, base, contents = ec_fixture
    # copy shard files to a scratch dir, drop 4, rebuild, compare
    import shutil
    scratch = str(tmp_path / "rebuild")
    os.makedirs(scratch)
    nb = os.path.join(scratch, "5")
    originals = {}
    for i in range(14):
        src = base + pl.to_ext(i)
        with open(src, "rb") as f:
            originals[i] = hashlib.sha256(f.read()).hexdigest()
        if i not in (2, 6, 11, 13):
            shutil.copy(src, nb + pl.to_ext(i))
    rebuilt = pl.rebuild_ec_files(nb, encoder=pl.get_encoder("cpu"))
    assert sorted(rebuilt) == [2, 6, 11, 13]
    for i in rebuilt:
        with open(nb + pl.to_ext(i), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == originals[i], i


def test_rebuild_sequential_matches_batched(ec_fixture, tmp_path):
    """The bench baseline: sequential per-shard rebuild produces
    byte-identical shards to the batched one-matmul-per-window path,
    and the stats show batched reading the survivors ONCE while
    sequential re-reads them per lost shard."""
    import shutil
    d, base, _ = ec_fixture
    lost = (2, 6, 11, 13)
    originals = {}
    dirs = {}
    for mode in ("seq", "batch"):
        scratch = str(tmp_path / mode)
        os.makedirs(scratch)
        dirs[mode] = os.path.join(scratch, "5")
        for i in range(14):
            src = base + pl.to_ext(i)
            if mode == "seq":
                with open(src, "rb") as f:
                    originals[i] = hashlib.sha256(f.read()).hexdigest()
            if i not in lost:
                shutil.copy(src, dirs[mode] + pl.to_ext(i))
    stats = {"seq": {}, "batch": {}}
    assert sorted(pl.rebuild_ec_files(
        dirs["seq"], encoder=pl.get_encoder("cpu"), sequential=True,
        stats=stats["seq"])) == list(lost)
    assert sorted(pl.rebuild_ec_files(
        dirs["batch"], encoder=pl.get_encoder("cpu"),
        stats=stats["batch"])) == list(lost)
    for mode in ("seq", "batch"):
        for i in lost:
            with open(dirs[mode] + pl.to_ext(i), "rb") as f:
                assert hashlib.sha256(
                    f.read()).hexdigest() == originals[i], (mode, i)
    assert stats["seq"]["bytes_read"] == \
        len(lost) * stats["batch"]["bytes_read"]
    assert stats["seq"]["bytes_rebuilt"] == stats["batch"]["bytes_rebuilt"]
    assert stats["batch"]["launches"] < stats["seq"]["launches"]


def test_rebuild_unrepairable(tmp_path, ec_fixture):
    import shutil
    d, base, _ = ec_fixture
    nb = str(tmp_path / "5")
    for i in range(9):  # only 9 shards
        shutil.copy(base + pl.to_ext(i), nb + pl.to_ext(i))
    with pytest.raises(ValueError, match="unrepairable"):
        pl.rebuild_ec_files(nb, encoder=pl.get_encoder("cpu"))


def test_decode_back_to_dat(ec_fixture, tmp_path):
    import shutil
    d, base, contents = ec_fixture
    nb = str(tmp_path / "5")
    for i in range(10):
        shutil.copy(base + pl.to_ext(i), nb + pl.to_ext(i))
    shutil.copy(base + ".ecx", nb + ".ecx")
    dat_size = os.path.getsize(base + ".dat")
    # trailing tombstone records have no live .ecx entry, so the recovered
    # size covers the live prefix only (same as reference FindDatFileSize)
    found = pl.find_dat_file_size(nb)
    assert found <= dat_size
    pl.write_dat_file(nb, found, large_block=LB, small_block=SB)
    with open(base + ".dat", "rb") as a, open(nb + ".dat", "rb") as b:
        assert a.read(found) == b.read()


def test_ec_delete_journal(ec_fixture):
    d, base, contents = ec_fixture
    ev = EcVolume(d, "", 5, large_block=LB, small_block=SB,
                  encoder=pl.get_encoder("cpu"))
    victim = next(iter(contents))
    ev.read_needle(victim)
    ev.delete_needle(victim)
    with pytest.raises(NotFoundError):
        ev.read_needle(victim)
    ev.close()
    # journal recorded
    with open(base + ".ecj", "rb") as f:
        assert int.from_bytes(f.read(8), "big") == victim
    # reopening still sees the tombstone (persisted into .ecx)
    ev2 = EcVolume(d, "", 5, large_block=LB, small_block=SB)
    with pytest.raises(NotFoundError):
        ev2.read_needle(victim)
    ev2.close()


def test_batched_encode_matches_serial(tmp_path):
    """write_ec_files_batched must produce byte-identical shard files to
    the serial path for volumes of DIFFERENT sizes (rack-encode shape,
    uneven tail), including parity placement across flush groups."""
    import random as _random
    rng = _random.Random(23)
    sizes = [5 * LB * 10 + 3 * SB * 10 + 40,   # large rows + ragged tail
             2 * SB * 10 + 7,                  # small rows only
             LB * 10 + SB * 10]                # exact boundary
    serial, batched = [], []
    for i, size in enumerate(sizes):
        payload = bytes(rng.getrandbits(8) for _ in range(size))
        for tag, acc in (("s", serial), ("b", batched)):
            base = str(tmp_path / f"{tag}{i}")
            with open(base + ".dat", "wb") as f:
                f.write(payload)
            acc.append(base)
    enc = pl.get_encoder("cpu")
    for base in serial:
        pl.write_ec_files(base, encoder=enc, large_block=LB,
                          small_block=SB, buffer_size=SB)
    pl.write_ec_files_batched(batched, encoder=enc, large_block=LB,
                              small_block=SB, buffer_size=SB,
                              batch_volumes=4)
    for sbase, bbase in zip(serial, batched):
        for sid in range(14):
            with open(sbase + pl.to_ext(sid), "rb") as a, \
                    open(bbase + pl.to_ext(sid), "rb") as b:
                assert a.read() == b.read(), (sbase, sid)


def test_overlapped_pipeline_error_propagates(tmp_path):
    """A transform failure mid-stream must raise out of write_ec_files
    (not deadlock the reader/writer threads) and must not be swallowed."""
    import threading

    d = str(tmp_path)
    v = Volume(d, "", 7)
    rng = random.Random(3)
    for i in range(1, 30):
        v.write_needle(Needle(cookie=1, id=i,
                              data=bytes(rng.getrandbits(8)
                                         for _ in range(2000))))
    v.close()
    base = os.path.join(d, "7")

    from seaweedfs_tpu_torch.ec.encoder_torch import TorchEncoder

    calls = {"n": 0}
    from seaweedfs_tpu_torch.ec import pipeline as plmod
    from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
    orig = plmod.transform_block_async

    def exploding(encoder, coeff, block, stats=None):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("kaboom")
        # stay off the device path under the fake: compute via numpy
        return orig(CpuEncoder(use_native=False), coeff, block, stats)

    plmod.transform_block_async = exploding
    # the port threads the pipeline only for a CUDA encoder: force the
    # threaded path for the plain version on the CPU
    orig_overlap = plmod._use_overlap
    plmod._use_overlap = lambda encoder: True
    try:
        before = threading.active_count()
        with pytest.raises(RuntimeError, match="kaboom"):
            # the THREADED pipeline (_use_overlap) is the error path
            # under test; batch_windows=1 keeps enough blocks in the
            # stream for call 3 to land
            pl.write_ec_files(base, encoder=TorchEncoder(device="cpu"),
                              large_block=LB, small_block=SB,
                              buffer_size=SB, batch_windows=1)
        # pipeline threads joined, none leaked
        assert threading.active_count() <= before
    finally:
        plmod.transform_block_async = orig
        plmod._use_overlap = orig_overlap


def test_ec_backend_env_override(monkeypatch):
    """SWTPU_TORCH_EC_BACKEND (the volume CLI's -ecBackend flag) pins the
    engine choice regardless of the attached card: the port's form of
    the reference case, whose SWTPU_EC_BACKEND and `tpu` pin become
    SWTPU_TORCH_EC_BACKEND and `gpu`."""
    import torch
    from seaweedfs_tpu_torch.ec.encoder_torch import TorchEncoder

    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    enc = pl.get_encoder()
    assert isinstance(enc, TorchEncoder) and enc.device.type == "cpu"
    # a gpu pin on a host without a card fails fast, never the CPU
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "gpu")
    if torch.cuda.is_available():
        assert pl.get_encoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            pl.get_encoder()
    # explicit argument still wins over the env
    assert pl.get_encoder("cpu").device.type == "cpu"
    # garbage values are rejected, not silently mapped to cpu
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "tpu")
    with pytest.raises(ValueError, match="unknown EC backend"):
        pl.get_encoder()
