"""The GF(256) transform of the port (ops/gf256_cuda.py) against the JAX
package: the plain PyTorch version equals the Pallas kernel K1 run in
interpret mode, encoder_jax._apply_bitplanes and the numpy CpuEncoder,
byte for byte; the wrapper rejects what the CUDA kernel does not take;
the build module names the right target and reports a failed build.

The stacked entry (K2's port, gf256_stacked_transform) is held, through
its plain version, to the Pallas kernel K2 in interpret mode, and its
out= contract is checked: it writes into a strided view and nowhere
else, and rejects bad shapes, types, devices and overlap.

The CUDA kernel itself runs only on the card: the tests marked `gpu`
skip on a host without one (`pytest -m gpu tests/test_torch_ops.py` on
the card)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seaweedfs_tpu.ec import gf as ref_gf
from seaweedfs_tpu.ec.encoder_cpu import CpuEncoder
from seaweedfs_tpu.ec.encoder_jax import _apply_bitplanes
from seaweedfs_tpu.ops import gf256_pallas
from seaweedfs_tpu.ops.gf256_pallas import gf256_matmul_pallas
from seaweedfs_tpu_torch.ops import _build, gf256_cuda
from seaweedfs_tpu_torch.ops.gf256_cuda import (
    gf256_stacked_transform, gf256_stacked_transform_reference,
    gf256_transform, gf256_transform_reference)


def _present(lost):
    return [i for i in range(14) if i not in lost][:10]


COEFFS = {
    "encode": ref_gf.parity_matrix(),
    "lost0379": ref_gf.shard_rows([0, 3, 7, 9], _present([0, 3, 7, 9])),
    "lost10-13": ref_gf.shard_rows([10, 11, 12, 13],
                                   _present([10, 11, 12, 13])),
    "lost2_11": ref_gf.shard_rows([2, 11], _present([2, 11])),
    "lost5": ref_gf.shard_rows([5], _present([5])),
}


def _consts(coeff) -> torch.Tensor:
    return torch.from_numpy(ref_gf.bitplane_constants(coeff))


@pytest.mark.parametrize("name", sorted(COEFFS))
def test_plain_matches_pallas_interpret(name):
    """K1 through gf256_matmul_pallas in interpret mode, ragged n."""
    coeff = COEFFS[name]
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (10, 1000)).astype(np.uint8)
    want = np.asarray(gf256_matmul_pallas(ref_gf.bitplane_constants(coeff),
                                          data, block_bm=8, interpret=True))
    got = gf256_transform(_consts(coeff), torch.from_numpy(data)[None])[0]
    assert np.array_equal(got.numpy(), want)


def test_plain_matches_pallas_interpret_batched():
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (3, 10, 700)).astype(np.uint8)
    coeff = COEFFS["encode"]
    want = np.asarray(gf256_matmul_pallas(ref_gf.bitplane_constants(coeff),
                                          data, block_bm=8, interpret=True))
    got = gf256_transform(_consts(coeff), torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(COEFFS))
@pytest.mark.parametrize("length", [1, 13, 4096, 10007])
def test_plain_matches_apply_bitplanes_and_cpu_encoder(name, length):
    coeff = COEFFS[name]
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, (4, 10, length)).astype(np.uint8)
    got = gf256_transform(_consts(coeff), torch.from_numpy(data)).numpy()
    want_xla = np.asarray(_apply_bitplanes(ref_gf.bitplane_constants(coeff),
                                           data))
    assert np.array_equal(got, want_xla)
    for b in range(4):
        rows = CpuEncoder._apply_numpy(coeff, list(data[b]))
        assert np.array_equal(got[b], np.stack(rows)), b


def test_plain_takes_strided_views():
    """The verify path hands over the data rows of a (B, 14, L) block."""
    rng = np.random.default_rng(3)
    block = torch.from_numpy(rng.integers(0, 256, (5, 14, 999)
                                          ).astype(np.uint8))
    view = block[:, :10]
    assert not view.is_contiguous()
    consts = _consts(COEFFS["encode"])
    assert torch.equal(gf256_transform(consts, view),
                       gf256_transform(consts, view.contiguous()))


def test_plain_max_shape_and_empty():
    rng = np.random.default_rng(4)
    coeff = rng.integers(0, 256, (16, 16)).astype(np.uint8)
    data = rng.integers(0, 256, (2, 16, 77)).astype(np.uint8)
    got = gf256_transform(_consts(coeff), torch.from_numpy(data)).numpy()
    for b in range(2):
        assert np.array_equal(got[b], np.stack(
            CpuEncoder._apply_numpy(coeff, list(data[b]))))
    empty = gf256_transform(_consts(COEFFS["encode"]),
                            torch.zeros((3, 10, 0), dtype=torch.uint8))
    assert empty.shape == (3, 4, 0)


def test_launch_counts_are_raised_under_the_lock(monkeypatch):
    """The volume server launches from several executor threads at once
    (an admin request, a degraded read, the scrubber). count_launch
    raises each count only while it holds _count_lock: a thread that
    counts waits while another holds the lock, and the count it adds is
    there once the lock is free."""
    import threading
    monkeypatch.setattr(gf256_cuda, "launches", 0)
    monkeypatch.setattr(gf256_cuda, "stacked_launches", 0)
    for stacked, held, after in ((False, (0, 0), (1, 0)),
                                 (True, (1, 0), (1, 1))):
        with gf256_cuda._count_lock:
            t = threading.Thread(target=gf256_cuda.count_launch,
                                 args=(stacked,))
            t.start()
            t.join(timeout=0.2)
            assert t.is_alive()
            assert (gf256_cuda.launches, gf256_cuda.stacked_launches) \
                == held
        t.join(timeout=10)
        assert not t.is_alive()
        assert (gf256_cuda.launches, gf256_cuda.stacked_launches) == after

    def many(stacked):
        for _ in range(5000):
            gf256_cuda.count_launch(stacked=stacked)
    threads = [threading.Thread(target=many, args=(i % 2 == 1,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (gf256_cuda.launches, gf256_cuda.stacked_launches) == \
        (1 + 4 * 5000, 1 + 4 * 5000)


def test_cpu_tensors_run_the_plain_version_without_counting():
    before = gf256_cuda.launches
    x = torch.zeros((1, 10, 64), dtype=torch.uint8)
    gf256_transform(_consts(COEFFS["encode"]), x)
    assert gf256_cuda.launches == before


@pytest.mark.parametrize("case", [
    "x_dtype", "consts_dtype", "x_2d", "k_mismatch", "consts_shape",
    "too_many_rows", "too_many_inputs", "not_tensors", "device_mismatch",
    "no_kernel_for_device"])
def test_wrapper_rejects_bad_inputs(case):
    consts = _consts(COEFFS["encode"])
    x = torch.zeros((2, 10, 32), dtype=torch.uint8)
    wide = torch.zeros((17, 10, 8), dtype=torch.uint8)
    deep = torch.zeros((4, 17, 8), dtype=torch.uint8)
    meta_x = torch.empty((2, 10, 32), dtype=torch.uint8, device="meta")
    meta_c = torch.empty((4, 10, 8), dtype=torch.uint8, device="meta")
    args, exc = {
        "x_dtype": ((consts, x.int()), TypeError),
        "consts_dtype": ((consts.int(), x), TypeError),
        "x_2d": ((consts, x[0]), ValueError),
        "k_mismatch": ((consts, x[:, :9]), ValueError),
        "consts_shape": ((consts[..., :7], x), ValueError),
        "too_many_rows": ((wide, x), ValueError),
        "too_many_inputs": ((deep, torch.zeros((1, 17, 8), dtype=torch.uint8)),
                            ValueError),
        "not_tensors": ((consts.numpy(), x), TypeError),
        "device_mismatch": ((meta_c, x), ValueError),
        "no_kernel_for_device": ((meta_c, meta_x), ValueError),
    }[case]
    with pytest.raises(exc):
        gf256_transform(*args)
    if case != "no_kernel_for_device":  # the plain version runs anywhere
        with pytest.raises(exc):
            gf256_transform_reference(*args)


@pytest.mark.parametrize("name,b,wm,bm", [
    ("encode", 1, 1, 256), ("encode", 3, 5, 2), ("lost0379", 3, 5, 2),
    ("lost0379", 1, 264, 256)])
def test_stacked_plain_matches_pallas_k2_interpret(name, b, wm, bm):
    """K2 through gf256_stacked_transform in interpret mode; wm = 264
    makes K2 fall back to a gcd block size (the CUDA kernel has no block
    quantum, so the port has nothing to fall back on)."""
    coeff = COEFFS[name]
    rng = np.random.default_rng(wm)
    data = rng.integers(0, 256, (b, 10, wm * 512)).astype(np.uint8)
    want = np.asarray(gf256_pallas.words_to_u8(
        gf256_pallas.gf256_stacked_transform(
            ref_gf.bitplane_constants(coeff),
            gf256_pallas.u8_to_words(jnp.asarray(data)), block_bm=bm,
            interpret=True)))
    x = torch.from_numpy(data)
    assert np.array_equal(
        gf256_stacked_transform_reference(_consts(coeff), x).numpy(), want)
    assert np.array_equal(gf256_stacked_transform(_consts(coeff), x).numpy(),
                          want)


@pytest.mark.parametrize("fn", [gf256_stacked_transform,
                                gf256_stacked_transform_reference])
def test_stacked_writes_into_a_strided_view_and_nowhere_else(fn):
    rng = np.random.default_rng(5)
    consts = _consts(COEFFS["encode"])
    x = torch.from_numpy(rng.integers(0, 256, (4, 10, 999)).astype(np.uint8))
    block = torch.from_numpy(rng.integers(0, 256, (4, 14, 999)
                                          ).astype(np.uint8))
    before = block.clone()
    got = fn(consts, x, out=block[:, 10:])
    assert got.data_ptr() == block[:, 10:].data_ptr()
    assert torch.equal(block[:, :10], before[:, :10])
    assert torch.equal(block[:, 10:], gf256_transform_reference(consts, x))
    # the data rows and the parity rows of one block interleave in memory
    # but share no byte: parity straight into the block is allowed
    fn(consts, block[:, :10], out=block[:, 10:])
    assert torch.equal(block[:, 10:],
                       gf256_transform_reference(consts, block[:, :10]))


def test_stacked_cpu_tensors_count_no_launch():
    before = (gf256_cuda.launches, gf256_cuda.stacked_launches)
    gf256_stacked_transform(_consts(COEFFS["encode"]),
                            torch.zeros((1, 10, 64), dtype=torch.uint8))
    assert (gf256_cuda.launches, gf256_cuda.stacked_launches) == before


@pytest.mark.parametrize("case", [
    "out_dtype", "out_not_tensor", "out_rows", "out_length", "out_device",
    "out_last_axis_strided", "out_is_x", "out_rows_of_x",
    "out_partial_row_of_x"])
def test_stacked_rejects_bad_out(case):
    consts = _consts(COEFFS["encode"])
    x = torch.zeros((2, 10, 32), dtype=torch.uint8)
    big = torch.zeros((2, 14, 40), dtype=torch.uint8)
    out, exc = {
        "out_dtype": (torch.zeros((2, 4, 32), dtype=torch.int32), TypeError),
        "out_not_tensor": (np.zeros((2, 4, 32), np.uint8), TypeError),
        "out_rows": (torch.zeros((2, 5, 32), dtype=torch.uint8), ValueError),
        "out_length": (torch.zeros((2, 4, 31), dtype=torch.uint8),
                       ValueError),
        "out_device": (torch.empty((2, 4, 32), dtype=torch.uint8,
                                   device="meta"), ValueError),
        "out_last_axis_strided": (torch.zeros((2, 4, 64), dtype=torch.uint8
                                              )[..., ::2], ValueError),
        "out_is_x": (x[:, :4], ValueError),
        "out_rows_of_x": (x[:, 3:7], ValueError),
        # row 9 of out shares bytes 8-31 with row 9 of x
        "out_partial_row_of_x": (big[:, 9:13, 8:], ValueError),
    }[case]
    if case == "out_partial_row_of_x":
        x = big[:, :10, :32]
    for fn in (gf256_stacked_transform, gf256_stacked_transform_reference):
        with pytest.raises(exc):
            fn(consts, x, out=out)


def test_build_targets_hopper_and_hashes_the_source(monkeypatch):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command("gf256_transform", "/tmp/x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert cmd[-1].endswith(os.path.join("csrc", "gf256_transform.cu"))
    path = _build.library_path("gf256_transform")
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libgf256_transform-")
    assert set(_build.SOURCES) == {
        f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu")}


def test_build_failure_raises_and_leaves_no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed for gf256_transform"):
        _build.build_all()
    assert os.listdir(tmp_path) == []


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


# -- the CUDA kernel's algorithm, in numpy --------------------------------
# gf256_transform.cu splits gf_mul(c, v) over the two nibbles of v and
# reads both halves from 16-entry tables that pack 4 output rows in one
# word; the model below builds those tables from the JAX package's
# bitplane constants and applies them as the kernel does, selector for
# selector, so the CPU tests hold the kernel's arithmetic to the reference.


def _byte_perm(x, y, s: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, s): byte n of the result is byte
    (s >> 4n) & 7 of the 8 bytes y:x (x in bytes 0-3)."""
    both = (np.asarray(x, np.uint64)
            | (np.asarray(y, np.uint64) << np.uint64(32)))
    out = np.zeros(both.shape, np.uint64)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xFF)) << \
            np.uint64(8 * n)
    return out.astype(np.uint32)


def _nibble_tables(consts: np.ndarray) -> np.ndarray:
    """(rows, k, 8) bitplane constants -> (G, k, 2, 16) uint32 tables,
    G = ceil(rows / 4): byte q of [g, i, h, u] is XOR_{j < 4, bit j of u}
    consts[4g + q, i, 4h + j], and zero for rows past the last."""
    rows, k, _ = consts.shape
    groups = -(-rows // 4)
    bits = (np.arange(16)[:, None] >> np.arange(4)[None, :]) & 1  # (16, 4)
    halves = consts.reshape(rows, k, 2, 1, 4).astype(np.uint32)
    bytes_ = np.bitwise_xor.reduce(halves * bits, axis=-1)  # (rows,k,2,16)
    padded = np.zeros((4 * groups, k, 2, 16), np.uint32)
    padded[:rows] = bytes_
    padded = padded.reshape(groups, 4, k, 2, 16)
    return sum(padded[:, q] << np.uint32(8 * q) for q in range(4))


def _transpose4(a):
    """The kernel's 4 x 4 byte transpose of column words a[0..3]."""
    t0 = _byte_perm(a[0], a[1], 0x5140)
    t1 = _byte_perm(a[0], a[1], 0x7362)
    u0 = _byte_perm(a[2], a[3], 0x5140)
    u1 = _byte_perm(a[2], a[3], 0x7362)
    return [_byte_perm(t0, u0, 0x5410), _byte_perm(t0, u0, 0x7632),
            _byte_perm(t1, u1, 0x5410), _byte_perm(t1, u1, 0x7632)]


def _apply_tables(consts: np.ndarray, x: np.ndarray) -> np.ndarray:
    """(rows, k, 8) constants, (B, k, L) uint8 -> (B, rows, L) uint8 the
    way the kernel's vector path computes each 16-byte chunk: the offsets
    (w << 2) & 0x3C3C3C3C and (w >> 2) & 0x3C3C3C3C, one __byte_perm per
    byte, two table reads XORed into the byte column's packed word, then
    the 4 x 4 transposes."""
    rows, k, _ = consts.shape
    tab = _nibble_tables(consts)
    groups = tab.shape[0]
    bsz, _, length = x.shape
    padded = -(-length // 16) * 16
    xp = np.zeros((bsz, k, padded), np.uint8)
    xp[..., :length] = x
    words = xp.view("<u4").reshape(bsz, k, padded // 16, 4)
    acc = np.zeros((groups, bsz, padded // 16, 16), np.uint32)
    for i in range(k):
        for word in range(4):
            w = words[:, i, :, word]
            lo = (w << np.uint32(2)) & np.uint32(0x3C3C3C3C)
            hi = (w >> np.uint32(2)) & np.uint32(0x3C3C3C3C)
            for b in range(4):
                ol = _byte_perm(lo, 0, 0x4440 + b) >> 2
                oh = _byte_perm(hi, 0, 0x4440 + b) >> 2
                acc[:, :, :, 4 * word + b] ^= tab[:, i, 0][:, ol] \
                    ^ tab[:, i, 1][:, oh]
    out = np.zeros((bsz, 4 * groups, padded // 16, 4), np.uint32)
    for g in range(groups):
        for word in range(4):
            row = _transpose4([acc[g, :, :, 4 * word + c] for c in range(4)])
            for q in range(4):
                out[:, 4 * g + q, :, word] = row[q]
    out = out.astype("<u4").view(np.uint8).reshape(bsz, 4 * groups, padded)
    return out[:, :rows, :length]


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke.py, whose every_byte(k, device) puts every value 0..255
    at each of the 16 byte lanes of a chunk in every input row, and whose
    kernel_cases are phase 2's."""
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


def test_nibble_tables_hold_gf_mul_by_each_nibble():
    """Byte q of T[g, i, 0, u] is gf_mul(C[4g+q, i], u), of T[g, i, 1, u]
    gf_mul(C[4g+q, i], u << 4), for every row, input and nibble."""
    rng = np.random.default_rng(21)
    for rows, k in ((1, 1), (4, 10), (5, 3), (13, 16), (16, 16)):
        coeff = rng.integers(0, 256, (rows, k)).astype(np.uint8)
        tab = _nibble_tables(ref_gf.bitplane_constants(coeff))
        assert tab.shape == (-(-rows // 4), k, 2, 16)
        assert tab.dtype == np.uint32
        for g in range(tab.shape[0]):
            for q in range(4):
                r = 4 * g + q
                got = (tab[g] >> np.uint32(8 * q)) & 0xFF
                for i in range(k):
                    for u in range(16):
                        want = ((ref_gf.gf_mul(int(coeff[r, i]), u),
                                 ref_gf.gf_mul(int(coeff[r, i]), u << 4))
                                if r < rows else (0, 0))
                        assert (got[i, 0, u], got[i, 1, u]) == want


def test_byte_perm_model_and_transpose():
    """The numpy __byte_perm follows CUDA's selector rule, and the four
    selectors of the transpose turn column words into row words."""
    assert _byte_perm(0x33221100, 0x77665544, 0x3210) == 0x33221100
    assert _byte_perm(0x33221100, 0x77665544, 0x7654) == 0x77665544
    assert _byte_perm(0x33221100, 0, 0x4442) == 0x22
    rng = np.random.default_rng(22)
    cols = rng.integers(0, 256, (4, 4)).astype(np.uint8)  # [column, row]
    a = [np.uint32(int.from_bytes(bytes(cols[c]), "little"))
         for c in range(4)]
    rows = _transpose4(a)
    for q in range(4):
        assert int(rows[q]) == int.from_bytes(bytes(cols[:, q]), "little")


def _table_case(smoke, rows: int, k: int, seed: int):
    rng = np.random.default_rng(seed)
    coeff = rng.integers(0, 256, (rows, k)).astype(np.uint8)
    every = smoke.every_byte(k, torch.device("cpu")).numpy()
    data = np.concatenate([every, rng.integers(
        0, 256, (2, k, 4096)).astype(np.uint8)], axis=0)
    ragged = rng.integers(0, 256, (1, k, 333)).astype(np.uint8)
    return coeff, data, ragged


@pytest.mark.parametrize("rows", range(1, 17))
def test_table_model_matches_reference_for_every_row_count(smoke, rows):
    """rows 1..16 (k = 16 - rows + 1): every byte value at every lane, a
    random block and a ragged one, against _apply_bitplanes and the
    numpy CpuEncoder."""
    k = 17 - rows
    coeff, data, ragged = _table_case(smoke, rows, k, 100 + rows)
    consts = ref_gf.bitplane_constants(coeff)
    got = _apply_tables(consts, data)
    assert np.array_equal(got, np.asarray(_apply_bitplanes(consts, data)))
    for b in (0, 3):
        assert np.array_equal(got[b], np.stack(
            CpuEncoder._apply_numpy(coeff, list(data[b]))))
    assert np.array_equal(_apply_tables(consts, ragged)[0], np.stack(
        CpuEncoder._apply_numpy(coeff, list(ragged[0]))))


@pytest.mark.parametrize("k", range(1, 17))
def test_table_model_matches_reference_for_every_input_count(smoke, k):
    """k 1..16 at rows (k % 16) + 1: as above, with the plain PyTorch
    version as a third witness."""
    rows = k % 16 + 1
    coeff, data, ragged = _table_case(smoke, rows, k, 200 + k)
    consts = ref_gf.bitplane_constants(coeff)
    got = _apply_tables(consts, data)
    assert np.array_equal(got, np.asarray(_apply_bitplanes(consts, data)))
    assert np.array_equal(got, gf256_transform_reference(
        torch.from_numpy(consts), torch.from_numpy(data)).numpy())
    assert np.array_equal(_apply_tables(consts, ragged)[0], np.stack(
        CpuEncoder._apply_numpy(coeff, list(ragged[0]))))


@pytest.mark.parametrize("name", sorted(COEFFS))
def test_table_model_matches_reference_for_the_main_path(smoke, name):
    """The encode and rebuild matrices of the main path, every byte value
    at every lane."""
    coeff = COEFFS[name]
    consts = ref_gf.bitplane_constants(coeff)
    data = smoke.every_byte(10, torch.device("cpu")).numpy()
    assert np.array_equal(_apply_tables(consts, data),
                          np.asarray(_apply_bitplanes(consts, data)))


def test_table_model_on_every_phase2_case(smoke):
    """Every case chip_smoke.py's phase 2 holds the kernel to, rehearsed
    at a small window: the table model equals the plain version."""
    cases = smoke.kernel_cases(torch.device("cpu"), 0, 4096)
    for name, consts, x in cases:
        want = gf256_transform_reference(consts, x).numpy()
        got = _apply_tables(consts.numpy(), x.contiguous().numpy())
        assert np.array_equal(got, want), name


@pytest.mark.gpu
def test_kernel_matches_plain(smoke):
    """On the card: the CUDA kernel equals its plain version, byte for
    byte, for encode and rebuild matrices, ragged and strided inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    before = gf256_cuda.launches
    for coeff in COEFFS.values():
        consts = _consts(coeff).to(dev)
        for shape in ((1, 10, 1 << 20), (8, 10, 4096), (2, 10, (1 << 20) + 3),
                      (3, 10, 1)):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                              generator=gen)
            assert torch.equal(gf256_transform(consts, x),
                               gf256_transform_reference(consts, x))
        block = torch.randint(0, 256, (4, 14, 5000), dtype=torch.uint8,
                              device=dev, generator=gen)
        assert torch.equal(gf256_transform(consts, block[:, :10]),
                           gf256_transform_reference(consts, block[:, :10]))
        x = smoke.every_byte(10, dev)
        assert torch.equal(gf256_transform(consts, x),
                           gf256_transform_reference(consts, x))
    # partial groups of 4 rows, k = 1 and 16, every byte at every lane
    rng = np.random.default_rng(7)
    extra = [(5, 10), (8, 10), (13, 16), (16, 16), (4, 1), (7, 3)]
    for rows, k in extra:
        consts = _consts(rng.integers(0, 256, (rows, k))).to(dev)
        x = smoke.every_byte(k, dev)
        got = gf256_transform(consts, x)
        assert torch.equal(got, gf256_transform_reference(consts, x))
        assert np.array_equal(got.cpu().numpy(),
                              _apply_tables(consts.cpu().numpy(),
                                            x.cpu().numpy()))
    torch.cuda.synchronize()
    assert gf256_cuda.launches == before + 6 * len(COEFFS) + len(extra)


@pytest.mark.gpu
def test_stacked_kernel_matches_plain(smoke):
    """On the card: the stacked entry equals its plain version, byte for
    byte, into a fresh output and into the strided parity rows of a
    (B, 14, L) block, at a ragged L, and counts its own launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    before = (gf256_cuda.launches, gf256_cuda.stacked_launches)
    calls = 0
    for coeff in (COEFFS["encode"], COEFFS["lost0379"]):
        consts = _consts(coeff).to(dev)
        for shape in ((3, 10, 264 * 512 + 5), (1, 10, 1 << 20), (2, 10, 1)):
            x = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                              generator=gen)
            assert torch.equal(gf256_stacked_transform(consts, x),
                               gf256_stacked_transform_reference(consts, x))
            block = torch.randint(0, 256, (shape[0], 14, shape[2]),
                                  dtype=torch.uint8, device=dev,
                                  generator=gen)
            plain = block.clone()
            gf256_stacked_transform(consts, x, out=block[:, 10:])
            gf256_stacked_transform_reference(consts, x, out=plain[:, 10:])
            assert torch.equal(block, plain)
            calls += 2
    # every byte at every lane and partial groups, into rows that start
    # 1..15 bytes off a 16-byte boundary
    rng = np.random.default_rng(8)
    for rows, k in ((4, 10), (5, 10), (13, 16)):
        consts = _consts(rng.integers(0, 256, (rows, k))).to(dev)
        x = smoke.every_byte(k, dev)
        for off in (0, 1, 7, 15):
            block = torch.zeros((2, k + rows, 4096 + 16), dtype=torch.uint8,
                                device=dev)
            out = block[:, k:, off:off + 4096]
            gf256_stacked_transform(consts, x, out=out)
            assert torch.equal(out, gf256_stacked_transform_reference(
                consts, x))
            assert not block[:, k:, :off].any()
            assert not block[:, k:, off + 4096:].any()
            calls += 1
    torch.cuda.synchronize()
    assert (gf256_cuda.launches, gf256_cuda.stacked_launches) == (
        before[0], before[1] + calls)
