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


@pytest.mark.gpu
def test_kernel_matches_plain():
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
    torch.cuda.synchronize()
    assert gf256_cuda.launches == before + 5 * len(COEFFS)


@pytest.mark.gpu
def test_stacked_kernel_matches_plain():
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
    torch.cuda.synchronize()
    assert (gf256_cuda.launches, gf256_cuda.stacked_launches) == (
        before[0], before[1] + calls)
