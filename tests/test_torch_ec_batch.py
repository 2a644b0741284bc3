"""Stripe-batch engine property tests: random window batches and random
missing-sets through every available backend (cpu-numpy / cpu-native /
torch-cpu) must be byte-identical to the per-window numpy oracle —
encode, verify verdicts, and reconstruction alike (ec/batch.py + the
batched encoder surface). Runs under JAX_PLATFORMS=cpu in tier-1; the
native kernel skips cleanly when unavailable.

The cases of tests/test_ec_batch.py pointed at the port, with the JAX
package's TPU backend replaced by the port's TorchEncoder on the CPU (its
kernel's plain version). The batch engine's result for the host encoders
is held to the JAX package's bytes on the same seeded blocks, and a
volume encoded through the host CpuEncoder to the JAX package's shards."""

import hashlib
import os
import random

import numpy as np
import pytest

from seaweedfs_tpu.ec import batch as ref_ecb
from seaweedfs_tpu.ec import pipeline as ref_pl
from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder as RefCpuEncoder
from seaweedfs_tpu_torch.ec import batch as ecb
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
from seaweedfs_tpu_torch.ec.encoder_torch import TorchEncoder
from seaweedfs_tpu_torch.storage.needle import Needle
from seaweedfs_tpu_torch.storage.volume import Volume

BACKENDS = ("cpu-numpy", "cpu-native", "torch-cpu")


def make_encoder(name):
    if name == "cpu-numpy":
        return CpuEncoder(use_native=False)
    if name == "cpu-native":
        from seaweedfs_tpu_torch.native import gf256 as _native
        if not _native.available():
            pytest.skip("native GF(256) kernel not built on this host")
        return CpuEncoder(use_native=True)
    return TorchEncoder(device="cpu")


@pytest.fixture(params=BACKENDS)
def backend(request):
    return request.param, make_encoder(request.param)


@pytest.fixture(scope="module")
def oracle():
    return CpuEncoder(use_native=False)


def _oracle_full(oracle, block):
    """Per-window numpy encode: THE byte-identity reference."""
    return np.stack([np.stack(oracle.encode(list(w))) for w in block])


# ---------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------

def test_batch_encode_matches_perwindow_oracle(backend, oracle):
    name, enc = backend
    rng = np.random.default_rng(101)
    # batch sizes incl. B=1 and non-multiples of device counts; window
    # lengths incl. odd (not a block-quantum multiple)
    for bsz, n in [(1, 512), (3, 1000), (8, 4096), (5, 64)]:
        block = rng.integers(0, 256, (bsz, gf.DATA_SHARDS, n)
                             ).astype(np.uint8)
        want = _oracle_full(oracle, block)
        got = np.asarray(enc.encode_batch(block))
        assert got.shape == (bsz, gf.TOTAL_SHARDS, n), (name, got.shape)
        assert np.array_equal(got, want), (name, bsz, n)
        # the engine counts exactly one dispatch per block
        stats = {}
        par = ecb.transform_block(enc, gf.parity_matrix(), block, stats)
        assert np.array_equal(par, want[:, gf.DATA_SHARDS:, :])
        assert stats == {"dispatches": 1, "batches": 1, "windows": bsz,
                         "bytes_in": block.nbytes}
        # the JAX package's engine on the same block, through its host
        # encoder: the same parity bytes and the same accounting
        ref_stats = {}
        ref_par = ref_ecb.transform_block(
            RefCpuEncoder(use_native=False), gf.parity_matrix(), block,
            ref_stats)
        assert np.array_equal(np.asarray(par), ref_par)
        assert ref_stats == stats


def test_batch_refuses_an_unknown_encoder():
    """An encoder that is neither the host CpuEncoder nor a TorchEncoder
    raises the pipeline's TypeError before any work."""
    block = np.zeros((1, gf.DATA_SHARDS, 8), np.uint8)
    with pytest.raises(TypeError, match="TorchEncoder or a CpuEncoder"):
        ecb.transform_block(object(), gf.parity_matrix(), block)


# ---------------------------------------------------------------------
# verify
# ---------------------------------------------------------------------

def test_batch_verify_localizes_random_corruption(backend, oracle):
    name, enc = backend
    rng = np.random.default_rng(202)
    block = rng.integers(0, 256, (6, gf.DATA_SHARDS, 777)).astype(np.uint8)
    full = _oracle_full(oracle, block)
    assert ecb.verify_block(enc, full) == [True] * 6, name
    for _ in range(8):
        bad = full.copy()
        hits = sorted({int(rng.integers(0, 6))
                       for _ in range(rng.integers(1, 4))})
        for w in hits:
            sid = int(rng.integers(0, gf.TOTAL_SHARDS))
            off = int(rng.integers(0, 777))
            bad[w, sid, off] ^= int(rng.integers(1, 256))
        verdicts = ecb.verify_block(enc, bad)
        assert verdicts == [w not in hits for w in range(6)], \
            (name, hits, verdicts)


def test_unified_verify_signature(backend, oracle):
    """Satellite: every backend answers the same verify(block) -> bool
    for a list of rows AND a stacked array — the shape
    EcVolume.verify_window relies on with no per-encoder branching."""
    name, enc = backend
    rng = np.random.default_rng(303)
    window = rng.integers(0, 256, (gf.DATA_SHARDS, 640)).astype(np.uint8)
    full = np.stack(oracle.encode(list(window)))
    assert bool(enc.verify(full)) is True, name
    assert bool(enc.verify([r for r in full])) is True, name
    bad = full.copy()
    bad[11, 3] ^= 0x40
    assert bool(enc.verify(bad)) is False, name
    assert bool(enc.verify([r for r in bad])) is False, name


# ---------------------------------------------------------------------
# reconstruct
# ---------------------------------------------------------------------

def test_batch_reconstruct_random_missing_sets(backend, oracle):
    """Random missing-sets of size 1..4: rebuilding the lost rows from
    k survivors must be byte-identical to the originals on every
    backend, for every window of the batch."""
    name, enc = backend
    rng = np.random.default_rng(404)
    block = rng.integers(0, 256, (4, gf.DATA_SHARDS, 1536)
                         ).astype(np.uint8)
    full = _oracle_full(oracle, block)
    cases = [(0,), (13,), (0, 1, 2, 3), (10, 11, 12, 13), (0, 5, 11, 13)]
    for _ in range(10):
        m = int(rng.integers(1, gf.PARITY_SHARDS + 1))
        cases.append(tuple(sorted(
            rng.choice(gf.TOTAL_SHARDS, size=m, replace=False).tolist())))
    for missing in cases:
        present = [i for i in range(gf.TOTAL_SHARDS)
                   if i not in missing][:gf.DATA_SHARDS]
        rec = np.asarray(enc.reconstruct_batch(present, list(missing),
                                               full[:, present, :]))
        assert np.array_equal(rec, full[:, list(missing), :]), \
            (name, missing)


# ---------------------------------------------------------------------
# the three bulk paths: batched == per-window on a real volume
# ---------------------------------------------------------------------

LB, SB = 16 * 1024, 1024


@pytest.fixture(scope="module")
def small_volume(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ecbatch"))
    v = Volume(d, "", 9)
    rng = random.Random(7)
    # big enough to span BOTH striping areas: >= 2 large-block rows
    # (where consecutive windows are contiguous per shard and preads
    # coalesce) plus a small-block tail
    for i in range(1, 120):
        v.write_needle(Needle(cookie=i, id=i,
                              data=rng.randbytes(rng.randint(2000, 5000))))
    v.close()
    return d, os.path.join(d, "9")


def _shard_digest(base):
    h = hashlib.sha256()
    for sid in range(gf.TOTAL_SHARDS):
        with open(base + pl.to_ext(sid), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def test_encode_volume_batched_is_byte_identical(small_volume):
    d, base = small_volume
    sums, stats = {}, {}
    for bw in (1, 8):
        s: dict = {}
        pl.encode_volume(base, encoder=pl.get_encoder("cpu"),
                         large_block=LB, small_block=SB, buffer_size=SB,
                         batch_windows=bw, stats=s)
        sums[bw], stats[bw] = _shard_digest(base), s
    assert sums[1] == sums[8]
    w = stats[1]["windows"]
    assert stats[1]["dispatches"] == w
    assert stats[8]["dispatches"] <= -(-w // 8)
    assert stats[8]["preads"] < stats[1]["preads"]
    pl.write_sorted_file_from_idx(base)


def test_verify_parity_batched_matches_perwindow(small_volume):
    d, base = small_volume
    if not os.path.exists(base + ".ecx"):
        pl.write_sorted_file_from_idx(base)
    window = 4 * 1024
    ev = EcVolume(d, "", 9, large_block=LB, small_block=SB,
                  encoder=pl.get_encoder("cpu"))
    try:
        # plant rot in two windows of a parity shard (bytes no
        # foreground read visits)
        p = base + pl.to_ext(11)
        with open(p, "r+b") as f:
            for off in (window + 3, 3 * window + 9):
                f.seek(off)
                b = f.read(1)
                f.seek(off)
                f.write(bytes([b[0] ^ 0x55]))
        r1 = ev.verify_parity(window, batch_windows=1)
        rb = ev.verify_parity(window, batch_windows=8)
        assert r1["bad_windows"] == rb["bad_windows"] == [window, 3 * window]
        assert r1["windows"] == rb["windows"]
        assert r1["dispatches"] == r1["windows"]
        assert rb["dispatches"] <= -(-r1["windows"] // 8)
        assert rb["preads"] < r1["preads"]
    finally:
        ev.close()


def test_rebuild_batched_is_byte_identical(small_volume):
    d, base = small_volume
    originals = {}
    for sid in (2, 12):
        with open(base + pl.to_ext(sid), "rb") as f:
            originals[sid] = f.read()
        os.remove(base + pl.to_ext(sid))
    stats: dict = {}
    rebuilt = pl.rebuild_ec_files(base, encoder=pl.get_encoder("cpu"),
                                  buffer_size=SB, batch_windows=8,
                                  stats=stats)
    assert sorted(rebuilt) == [2, 12]
    for sid, want in originals.items():
        with open(base + pl.to_ext(sid), "rb") as f:
            assert f.read() == want, sid
    w = -(-len(originals[2]) // SB)
    assert stats["launches"] <= -(-w // 8)


def test_encode_volume_through_the_host_encoder_equals_the_reference(
        tmp_path):
    """encode_volume and rebuild_ec_files given the host CpuEncoder (the
    batch engine computes eagerly with it) write the shard files the JAX
    package writes for the same volume through its CpuEncoder."""
    import shutil
    rng = random.Random(11)
    d = str(tmp_path / "port")
    v = Volume(d, "", 5)
    for i in range(1, 60):
        v.write_needle(Needle(cookie=i, id=i,
                              data=rng.randbytes(rng.randint(2000, 5000))))
    v.close()
    shutil.copytree(d, str(tmp_path / "ref"))
    digests = []
    for name, plmod, enc in (("port", pl, CpuEncoder()),
                             ("ref", ref_pl, RefCpuEncoder())):
        base = os.path.join(str(tmp_path / name), "5")
        plmod.encode_volume(base, encoder=enc, large_block=LB,
                            small_block=SB, buffer_size=SB)
        os.remove(base + pl.to_ext(3))
        plmod.rebuild_ec_files(base, encoder=enc, buffer_size=SB)
        digests.append(_shard_digest(base))
    assert digests[0] == digests[1]
