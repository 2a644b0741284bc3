"""K4's port (ops/gf256_mxu.py, the GF(2) bit-matrix product) against the
JAX package's ops/gf256_mxu.py.

The six cases of tests/test_mxu.py: the port's plain version against
JAX's `mxu_words_transform` on XLA-CPU, compared as bytes
(`words_to_bytes`), and the pipeline case where the port's switch acts.
The reference's `test_pipeline_with_mxu_method` never reaches its MXU
branch (`write_ec_files` -> `encode_volume` -> `transform_block_async`
stays on the bitplane path), so the port's version drives
SWTPU_TORCH_EC_METHOD=mxu where `_transform_buffers_async` is called:
`write_ec_files_batched`, an EcVolume recover at or above its
small_recover_bytes, and `localize_corrupt_rows`; the JAX package's
SWTPU_EC_METHOD alone moves nothing in the port.

Also: the port's byte-plane matrix is the p = 0 diagonal block of JAX's
`_plane_matrix`; the plain version's chunks of a small budget give the
same bytes; the wrapper rejects what the kernel does not take. The fused
kernel runs only on the card (the tests marked `gpu` skip here); a numpy
model of its index arithmetic is in tests/test_torch_mxu_fused.py.
"""

import os
import random

import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import gf as ref_gf
from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder as RefCpuEncoder
from seaweedfs_tpu.ops.gf256_mxu import _plane_matrix, mxu_words_transform
from seaweedfs_tpu.ops.gf256_pallas import bytes_to_words, words_to_bytes
from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ops import gf256_mxu
from seaweedfs_tpu_torch.ops.gf256_cuda import gf256_transform
from seaweedfs_tpu_torch.ops.gf256_mxu import (
    chunks, device_bitmatrix, gf2_bitmatrix_transform,
    gf2_bitmatrix_transform_reference)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(21)


def _jax(coeff, byte_rows, n, block_bm=8, **kw):
    words = [bytes_to_words(b, block_bm=block_bm) for b in byte_rows]
    outs = mxu_words_transform(np.asarray(coeff, np.uint8), words, **kw)
    return np.stack([words_to_bytes(np.asarray(o), n) for o in outs])


def _port(coeff, byte_rows, **kw):
    x = torch.from_numpy(np.stack(byte_rows))[None]
    out = gf2_bitmatrix_transform(device_bitmatrix(coeff, CPU), x, **kw)
    return out[0].numpy()


# -- the cases of tests/test_mxu.py ---------------------------------------

@pytest.mark.parametrize("n", [512, 4096, 128 * 1024])
def test_mxu_encode_matches_jax(rng, n):
    data = [rng.integers(0, 256, n).astype(np.uint8) for _ in range(10)]
    want = _jax(ref_gf.parity_matrix(), data, n)
    assert np.array_equal(_port(gf.parity_matrix(), data), want)
    cpu = RefCpuEncoder(use_native=False)
    assert np.array_equal(want, np.stack(cpu.encode(list(data))[10:]))


def test_mxu_encode_unaligned_padding(rng):
    n = 1000
    data = [rng.integers(0, 256, n).astype(np.uint8) for _ in range(10)]
    assert np.array_equal(_port(gf.parity_matrix(), data),
                          _jax(ref_gf.parity_matrix(), data, n))


@pytest.mark.parametrize("want_rows,present", [
    ([0, 1, 2, 3], list(range(4, 14))),
    ([0, 5, 11, 13], [1, 2, 3, 4, 6, 7, 8, 9, 10, 12]),
    ([7], [0, 1, 2, 3, 4, 5, 6, 8, 9, 10]),
])
def test_mxu_rebuild_coeffs(rng, want_rows, present):
    n = 2048
    cpu = RefCpuEncoder(use_native=False)
    shards = cpu.encode([rng.integers(0, 256, n).astype(np.uint8)
                         for _ in range(10)])
    coeff = ref_gf.shard_rows(want_rows, present)
    rows = [shards[i] for i in present]
    got = _port(gf.shard_rows(want_rows, present), rows)
    assert np.array_equal(got, _jax(coeff, rows, n))
    for j, sid in enumerate(want_rows):
        assert np.array_equal(got[j], shards[sid]), (want_rows, sid)


def test_mxu_multiple_wm_blocks(rng):
    n = 384 * 1024
    data = [rng.integers(0, 256, n).astype(np.uint8) for _ in range(10)]
    assert np.array_equal(_port(gf.parity_matrix(), data),
                          _jax(ref_gf.parity_matrix(), data, n,
                               block_bm=256))


def test_mxu_chunked_streaming(rng):
    """JAX streams through chunks of 16 word-rows, the port through
    chunks of a budget that holds 1000 columns: the same bytes, ragged
    last chunk included."""
    n = 5 * 8 * 512
    data = [rng.integers(0, 256, n).astype(np.uint8) for _ in range(10)]
    want = _jax(ref_gf.parity_matrix(), data, n, chunk_wm=16)
    budget = 1000 * (8 * 10 + 32 * 4)
    assert len(list(chunks(1, n, 10, 4, budget))) == -(-n // 992)
    assert np.array_equal(
        _port(gf.parity_matrix(), data, chunk_bytes=budget), want)


# -- the bit-matrix and the chunk plan -------------------------------------

@pytest.mark.parametrize("rows,k", [(4, 10), (1, 10), (16, 16), (3, 1)])
def test_byte_plane_matrix_is_the_word_matrix_diagonal_block(rng, rows, k):
    coeff = rng.integers(0, 256, (rows, k)).astype(np.uint8)
    words = _plane_matrix(coeff.tobytes(), rows, k)
    blocks = words.reshape(rows, 4, 8, k, 4, 8)
    bitmat = device_bitmatrix(coeff, CPU)
    assert bitmat.dtype == torch.int8
    assert bitmat.shape == (8 * rows, 8 * k)
    for p in range(4):
        assert np.array_equal(blocks[:, p, :, :, p, :].reshape(
            8 * rows, 8 * k), bitmat.numpy())
        for q in range(4):
            if q != p:
                assert not blocks[:, p, :, :, q, :].any()


@pytest.mark.parametrize("bsz,length,budget", [
    (8, 1 << 20, gf256_mxu.CHUNK_BYTES), (1, 1 << 20, 208 * 1000),
    (40, 333, 208 * 1000), (3, 7, 1), (64, 65536, gf256_mxu.CHUNK_BYTES),
    (2, 4 << 20, gf256_mxu.CHUNK_BYTES)])
def test_chunks_cover_the_block_once_within_the_budget(bsz, length,
                                                       budget):
    seen = np.zeros((bsz, length), np.int32)
    per_col = 8 * 10 + 32 * 4
    for b0, nb, l0, lc in chunks(bsz, length, 10, 4, budget):
        seen[b0:b0 + nb, l0:l0 + lc] += 1
        assert nb * lc * per_col <= max(budget, 16 * per_col)
        assert nb == 1 or (l0 == 0 and lc == length)
        assert l0 % 16 == 0
    assert (seen == 1).all()


def test_pipeline_block_takes_one_window_a_chunk():
    """At the pipeline's (8, 10, 1 MiB) block the 256 MiB budget holds
    one window's planes and sums (1 MiB x 208 B), so the block runs as 8
    chunks; the whole block's would be 1.6 GiB."""
    assert list(chunks(8, 1 << 20, 10, 4)) == [
        (b, 1, 0, 1 << 20) for b in range(8)]


# -- the wrapper ------------------------------------------------------------

def test_plain_equals_k1_plain_on_strided_and_ragged_views(rng):
    coeff = gf.shard_rows([0, 3, 7, 9], [1, 2, 4, 5, 6, 8, 10, 11, 12, 13])
    base = torch.from_numpy(rng.integers(0, 256, (3, 14, 4113)).astype(
        np.uint8))
    x = base[:, :10, 5:5 + 4101]
    got = gf2_bitmatrix_transform(device_bitmatrix(coeff, CPU), x)
    consts = torch.from_numpy(gf.bitplane_constants(coeff))
    assert torch.equal(got, gf256_transform(consts, x))


def test_cpu_tensors_run_the_plain_version_without_counting(rng,
                                                             monkeypatch):
    monkeypatch.setattr(gf256_mxu, "launches", 0)
    monkeypatch.setattr(gf256_mxu, "calls", 0)
    x = torch.from_numpy(rng.integers(0, 256, (2, 10, 99)).astype(np.uint8))
    bitmat = device_bitmatrix(gf.parity_matrix(), CPU)
    assert torch.equal(gf2_bitmatrix_transform(bitmat, x),
                       gf2_bitmatrix_transform_reference(bitmat, x))
    assert (gf256_mxu.launches, gf256_mxu.calls) == (0, 0)


@pytest.mark.parametrize("counter", ["launches", "calls"])
def test_launch_count_is_raised_under_the_lock(monkeypatch, counter):
    import threading
    monkeypatch.setattr(gf256_mxu, counter, 0)
    count = {"launches": gf256_mxu.count_launch,
             "calls": gf256_mxu.count_call}[counter]
    threads = [threading.Thread(target=lambda: [
        count() for _ in range(2000)]) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert getattr(gf256_mxu, counter) == 16000


@pytest.mark.parametrize("case", ["float x", "int bitmat", "bitmat 7 rows",
                                  "rows 17", "k mismatch", "2-D x",
                                  "devices differ", "list"])
def test_wrapper_rejects_bad_inputs(case):
    bitmat = device_bitmatrix(gf.parity_matrix(), CPU)
    x = torch.zeros((1, 10, 32), dtype=torch.uint8)
    args = {
        "float x": (bitmat, x.float(), TypeError),
        "int bitmat": (bitmat.to(torch.int32), x, TypeError),
        "bitmat 7 rows": (bitmat[:7], x, ValueError),
        "rows 17": (torch.zeros((136, 80), dtype=torch.int8), x,
                    ValueError),
        "k mismatch": (bitmat, torch.zeros((1, 9, 32), dtype=torch.uint8),
                       ValueError),
        "2-D x": (bitmat, x[0], ValueError),
        "devices differ": (bitmat.to("meta"), x, ValueError),
        "list": (bitmat, [[1]], TypeError),
    }[case]
    for fn in (gf2_bitmatrix_transform, gf2_bitmatrix_transform_reference):
        with pytest.raises(args[2]):
            fn(args[0], args[1])


@pytest.mark.gpu
def test_kernels_match_plain_and_k1_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    dev = torch.device("cuda", 0)
    assert chip_smoke.phase_mxu_vs_plain(dev, 0) == 0


# -- SWTPU_TORCH_EC_METHOD where the port's pipeline reads it ---------------

@pytest.fixture
def k4_calls(monkeypatch):
    """Calls into K4's wrapper (on the CPU it runs the plain version,
    which counts no launch), and the engine pinned to the CPU."""
    monkeypatch.setenv(pl.BACKEND_ENV, "cpu")
    calls = []
    real = gf256_mxu.gf2_bitmatrix_transform

    def spy(bitmat, x, *a, **kw):
        calls.append(tuple(x.shape))
        return real(bitmat, x, *a, **kw)

    monkeypatch.setattr(gf256_mxu, "gf2_bitmatrix_transform", spy)
    return calls


def _dats(tmp_path, seeds):
    bases = []
    for s in seeds:
        base = str(tmp_path / f"v{s}")
        with open(base + ".dat", "wb") as f:
            f.write(np.random.default_rng(s).integers(
                0, 256, 40960 + 977 * s).astype(np.uint8).tobytes())
        bases.append(base)
    return bases


def _shards(base):
    out = []
    for i in range(gf.TOTAL_SHARDS):
        with open(base + pl.to_ext(i), "rb") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("method", ["mxu", "", "jax-variable-only"])
def test_write_ec_files_batched_under_the_method(tmp_path, monkeypatch,
                                                 k4_calls, method):
    """write_ec_files_batched launches K4 exactly when
    SWTPU_TORCH_EC_METHOD=mxu, and its shard files equal the JAX
    package's write_ec_files on the numpy CpuEncoder either way."""
    from seaweedfs_tpu.ec import pipeline as ref_pl
    if method == "jax-variable-only":
        monkeypatch.setenv("SWTPU_EC_METHOD", "mxu")
        monkeypatch.delenv(pl.METHOD_ENV, raising=False)
    else:
        monkeypatch.setenv(pl.METHOD_ENV, method)
    bases = _dats(tmp_path, (1, 2))
    geometry = dict(large_block=4096, small_block=512)
    pl.write_ec_files_batched(bases, encoder=pl.get_encoder("cpu"),
                              buffer_size=512, **geometry)
    assert bool(k4_calls) == (method == "mxu")
    for base in bases:
        ref_base = base + "-ref"
        os.link(base + ".dat", ref_base + ".dat")
        ref_pl.write_ec_files(ref_base, encoder=RefCpuEncoder(
            use_native=False), buffer_size=512, **geometry)
        assert _shards(base) == _shards(ref_base)


@pytest.fixture
def ec_volume_dir(tmp_path):
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.volume import Volume
    d = str(tmp_path / "vol")
    os.makedirs(d)
    v = Volume(d, "", 9)
    r = random.Random(3)
    contents = {}
    for i in range(1, 41):
        data = r.randbytes(r.randint(100, 3000))
        v.write_needle(Needle(cookie=i * 7, id=i, data=data))
        contents[i] = data
    v.close()
    base = os.path.join(d, "9")
    pl.write_ec_files(base, encoder=pl.get_encoder("cpu"),
                      large_block=16 * 1024, small_block=1024,
                      buffer_size=1024)
    pl.write_sorted_file_from_idx(base)
    return d, base, contents


@pytest.mark.parametrize("method", ["mxu", ""])
def test_degraded_recover_under_the_method(ec_volume_dir, monkeypatch,
                                           k4_calls, method):
    """Recovers at or above small_recover_bytes (here 0: every one) go
    through K4 under SWTPU_TORCH_EC_METHOD=mxu and through K1 otherwise;
    every needle reads back equal either way."""
    from seaweedfs_tpu_torch.ec.ec_volume import EcVolume
    monkeypatch.setenv(pl.METHOD_ENV, method)
    d, _, contents = ec_volume_dir
    ev = EcVolume(d, "", 9, large_block=16 * 1024, small_block=1024,
                  small_recover_bytes=0)
    for sid in (0, 3, 7, 9):
        ev.shards.pop(sid).close()
    try:
        for nid, data in contents.items():
            assert ev.read_needle(nid, nid * 7).data == data
    finally:
        ev.close()
    assert bool(k4_calls) == (method == "mxu")
    assert all(shape[:2] == (1, gf.DATA_SHARDS) for shape in k4_calls)


@pytest.mark.parametrize("method", ["mxu", ""])
def test_localize_corrupt_rows_under_the_method(monkeypatch, k4_calls,
                                                method):
    """localize_corrupt_rows reconstructs each of the 14 hypotheses with
    one transform: 14 through K4 under the method, each verified on K1;
    the culprit is found either way."""
    from seaweedfs_tpu_torch.ec.batch import localize_corrupt_rows
    monkeypatch.setenv(pl.METHOD_ENV, method)
    r = np.random.default_rng(5)
    data = r.integers(0, 256, (gf.DATA_SHARDS, 3000)).astype(np.uint8)
    enc = pl.get_encoder("cpu")
    rows = enc.encode(data).numpy().copy()
    rows[12, 1234] ^= 0x21
    assert localize_corrupt_rows(enc, rows) == [12]
    assert len(k4_calls) == (gf.TOTAL_SHARDS if method == "mxu" else 0)
