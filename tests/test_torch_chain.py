"""The chain of a one-window card recover (seaweedfs_tpu_torch/ops/gf256_cuda.py
`gf256_chain`, csrc/gf256_transform.cu `swtpu_gf256_chain`).

A card recover of one (1, k, L) window is enqueued as one native chain of
pieces along L: each piece's survivor bytes are copied in on one stream,
and K1 over them and the copy out of their columns run on a second, so
they hide under the next piece's copy in. The plan is a function of L
alone (`piece_bounds`): one piece below CHAIN_MIN_BYTES, else pieces of
PIECE_BYTES or more, at most MAX_PIECES, a ragged last one. On the CPU the
chain runs the same pieces through the plain version, and the host and
plain paths of `_transform_buffers_async` are what they were. A stand-in
for K1 given to the chain runs over every piece. On the card (`-m gpu`)
the chain equals the plain version byte for byte, from one thread and
from eight at once, and a stand-in put in place of encoder_torch's K1
reaches a recover's answer."""

import threading

import numpy as np
import pytest
import torch

from seaweedfs_tpu_torch.ec import gf
from seaweedfs_tpu_torch.ec import pipeline as pl
from seaweedfs_tpu_torch.ec.encoder_cpu import CpuEncoder
from seaweedfs_tpu_torch.ec.encoder_torch import TorchEncoder
from seaweedfs_tpu_torch.ops import gf256_cuda as g

MIB = 1 << 20
LOST = (0, 3, 7, 9)
PRESENT = tuple(s for s in range(gf.TOTAL_SHARDS) if s not in LOST)[:10]
LENGTHS = (1, 15, 16, 4097, g.CHAIN_MIN_BYTES - 1, g.CHAIN_MIN_BYTES,
           g.CHAIN_MIN_BYTES + 1, MIB, MIB + 7, 3 * MIB + 1, 8 * MIB,
           64 * MIB + 5)


def recover_inputs(rows, length, seed=0):
    """(coeff, block): the matrix recovering the first `rows` of LOST
    from PRESENT and a seeded (1, 10, length) survivor block."""
    coeff = gf.cached_shard_rows(LOST[:rows], PRESENT)
    rng = np.random.default_rng(seed * 31 + rows)
    return coeff, rng.integers(0, 256, (1, 10, length), dtype=np.uint8)


@pytest.mark.parametrize("length", LENGTHS)
def test_the_pieces_cover_the_window_once_in_order(length):
    bounds = g.piece_bounds(length)
    assert bounds[0] == 0 and bounds[-1] == length
    assert all(b > a for a, b in zip(bounds, bounds[1:]))
    assert 1 <= len(bounds) - 1 <= g.MAX_PIECES
    # every piece but the last starts and ends on a 16-byte boundary
    assert all(b % 16 == 0 for b in bounds[:-1])


@pytest.mark.parametrize("length", [1, 4096, 300 << 10,
                                    g.CHAIN_MIN_BYTES - 1])
def test_one_piece_below_the_threshold(length):
    assert g.piece_bounds(length) == [0, length]


@pytest.mark.parametrize("length", [g.CHAIN_MIN_BYTES, MIB, 3 * MIB + 1,
                                    8 * MIB, 64 * MIB + 5])
def test_pieces_are_large_and_capped(length):
    bounds = g.piece_bounds(length)
    sizes = [b - a for a, b in zip(bounds, bounds[1:])]
    assert 2 <= len(sizes) <= g.MAX_PIECES
    assert min(sizes[:-1]) >= g.PIECE_BYTES
    assert len(g.piece_bounds(1 << 30)) - 1 == g.MAX_PIECES


def test_one_mib_is_even_and_an_odd_window_has_a_ragged_last_piece():
    even = g.piece_bounds(MIB)
    assert len({b - a for a, b in zip(even, even[1:])}) == 1
    odd = g.piece_bounds(MIB + 7)
    sizes = [b - a for a, b in zip(odd, odd[1:])]
    assert len(sizes) == len(even) - 1
    assert len(set(sizes[:-1])) == 1 and sizes[-1] < sizes[0]
    assert sum(sizes) == MIB + 7


@pytest.mark.parametrize("pieces", [1, 2, 3, 4, 8])
def test_split_bounds_gives_the_pieces_asked_for(pieces):
    bounds = g.split_bounds(MIB + 7, pieces)
    assert len(bounds) - 1 == pieces
    assert bounds[0] == 0 and bounds[-1] == MIB + 7


@pytest.mark.parametrize("native", [True, False])
def test_stage_pieces_lays_each_piece_out_whole(native, monkeypatch):
    """The native host library's copy and numpy's (where the library is
    not built) give the same piece-major layout, from a (k, L) array and
    from a list of rows."""
    if not native:
        monkeypatch.setattr(g.native_build, "load", lambda: None)
    elif g.native_build.load() is None:
        pytest.skip("the native host library is not built on this host")
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (10, 1000), dtype=np.uint8)
    bounds = [0, 96, 512, 1000]
    for src in (rows, list(rows)):
        flat = g.stage_pieces(src, bounds, np.empty(10 * 1000, np.uint8))
        for a, b in zip(bounds, bounds[1:]):
            assert np.array_equal(flat[10 * a:10 * b].reshape(10, b - a),
                                  rows[:, a:b])
    with pytest.raises(ValueError):
        g.stage_pieces(rows, bounds, np.empty(10 * 999, np.uint8))


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [4097, g.CHAIN_MIN_BYTES + 48])
def test_chain_plain_version_equals_the_host_encoder(rows, length):
    """On CPU tensors the chain runs its pieces through the plain version:
    the same bytes as CpuEncoder, at the plan and at three pieces."""
    coeff, block = recover_inputs(rows, length)
    want = CpuEncoder()._apply(coeff, list(block[0]))
    consts = torch.from_numpy(gf.bitplane_constants(coeff))
    for bounds in (g.piece_bounds(length), g.split_bounds(length, 3)):
        staged = g.stage_pieces(block[0], bounds,
                                np.empty(10 * length, np.uint8))
        dev_in = torch.empty(10 * length, dtype=torch.uint8)
        dev_out = torch.empty((1, rows, length), dtype=torch.uint8)
        host = torch.empty((1, rows, length), dtype=torch.uint8)
        g.gf256_chain(consts, torch.from_numpy(staged), dev_in, dev_out,
                      host, bounds)
        for r in range(rows):
            assert np.array_equal(host[0, r].numpy(), want[r])


def test_chain_refuses_bad_bounds_and_shapes():
    coeff, block = recover_inputs(2, 64)
    consts = torch.from_numpy(gf.bitplane_constants(coeff))
    flat = torch.from_numpy(block[0].ravel().copy())
    out = torch.empty((1, 2, 64), dtype=torch.uint8)
    # short of L, an empty piece, not from 0, more than MAX_PIECES
    for bounds in ([0, 32], [0, 32, 32, 64], [16, 64],
                   list(range(0, 64, 4)) + [64]):
        with pytest.raises(ValueError):
            g.gf256_chain(consts, flat, flat.clone(), out, out.clone(),
                          bounds)
    with pytest.raises(ValueError):
        g.gf256_chain(consts, flat, flat.clone(),
                      torch.empty((1, 3, 64), dtype=torch.uint8),
                      out, [0, 64])


@pytest.mark.parametrize("rows", [1, 2, 3, 4])
def test_host_and_plain_paths_are_unchanged(rows):
    """`_transform_buffers_async` off the card: the host CpuEncoder and
    the plain version of a TorchEncoder on the CPU give CpuEncoder's
    bytes, and report one piece each."""
    coeff, block = recover_inputs(rows, MIB + 7, seed=1)
    bufs = list(block[0])
    want = CpuEncoder()._apply(coeff, bufs)
    for encoder in (CpuEncoder(), TorchEncoder(device="cpu")):
        run = pl._transform_buffers_async(encoder, coeff, bufs)
        assert run.pieces == 1
        got = run()
        assert len(got) == rows
        for r in range(rows):
            assert np.array_equal(np.asarray(got[r]), want[r])


def flip_first(transform, consts, x, out=None):
    y = transform(consts, x, out)
    y[:, :, 0] ^= 1
    return y


def first_rows(transform, consts, x, out=None):
    return x[:, :consts.shape[0], :].clone()


def zero_half(transform, consts, x, out=None):
    y = transform(consts, x, out)
    y[:, :, y.shape[2] // 2:] = 0
    return y


STAND_INS = {"flip_first": flip_first, "first_rows": first_rows,
             "zero_half": zero_half}


def per_piece(stand_in, consts, block, bounds):
    """What a chain gives with `stand_in` as its K1: the stand-in's
    answer over each piece's columns, in place."""
    x = torch.from_numpy(block)
    want = torch.empty((1, consts.shape[0], x.shape[2]), dtype=torch.uint8)
    for a, b in zip(bounds, bounds[1:]):
        want[..., a:b] = stand_in(g.gf256_transform, consts,
                                  x[..., a:b].contiguous())
    return want


@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_the_chain_runs_the_transform_it_is_given(name):
    """A stand-in for K1 given to the chain is what each piece runs: the
    answer is the stand-in's over every piece, returned or written in
    place, so an altered K1 shows in a chain's output."""
    coeff, block = recover_inputs(3, g.CHAIN_MIN_BYTES + 48, seed=4)
    consts = torch.from_numpy(gf.bitplane_constants(coeff))
    bounds = g.piece_bounds(block.shape[2])
    assert len(bounds) > 2
    length = block.shape[2]
    staged = g.stage_pieces(block[0], bounds, np.empty(10 * length,
                                                       np.uint8))
    host = torch.empty((1, 3, length), dtype=torch.uint8)
    g.gf256_chain(consts, torch.from_numpy(staged),
                  torch.empty(10 * length, dtype=torch.uint8),
                  torch.empty((1, 3, length), dtype=torch.uint8), host,
                  bounds, transform=lambda c, x, out=None: STAND_INS[name](
                      g.gf256_transform, c, x, out))
    want = per_piece(STAND_INS[name], consts, block, bounds)
    assert torch.equal(host, want)
    plain = CpuEncoder()._apply(coeff, list(block[0]))
    assert not np.array_equal(host[0].numpy(), np.stack(plain))


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the chain has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_chain_matches_plain_on_the_card(monkeypatch):
    """On the card: the chain's output equals the plain version byte for
    byte, for 1-4 rows and L of 1 MiB, 1 MiB + 7 and 3 MiB + 1, and each
    chain counts one K1 launch a piece and reports the plan's pieces;
    under SWTPU_TORCH_EC_METHOD=mxu a recover is one piece."""
    dev = card()
    monkeypatch.delenv(pl.METHOD_ENV, raising=False)
    enc = TorchEncoder(device=dev)
    for rows in range(1, 5):
        for length in (MIB, MIB + 7, 3 * MIB + 1):
            coeff, block = recover_inputs(rows, length, seed=2)
            want = g.gf256_transform_reference(
                torch.from_numpy(gf.bitplane_constants(coeff)).to(dev),
                torch.from_numpy(block).to(dev)).cpu().numpy()
            before = g.launches
            run = pl._transform_buffers_async(enc, coeff, list(block[0]))
            got = np.stack(run())[None]
            assert g.launches - before == len(g.piece_bounds(length)) - 1
            assert run.pieces == len(g.piece_bounds(length)) - 1
            assert np.array_equal(got, want), (rows, length)
    monkeypatch.setenv(pl.METHOD_ENV, "mxu")
    run = pl._transform_buffers_async(enc, coeff, list(block[0]))
    assert run.pieces == 1
    assert np.array_equal(np.stack(run())[None], want)


@pytest.mark.gpu
def test_eight_threads_recover_at_once_through_the_chain():
    """On the card: 8 threads each recover their own windows through the
    chain at once, sharing its two streams and its event pool; every
    output is exact."""
    dev = card()
    enc = TorchEncoder(device=dev)
    inputs = [recover_inputs(1 + t % 4, MIB + 16 * t, seed=10 + t)
              for t in range(8)]
    wants = [CpuEncoder()._apply(c, list(b[0])) for c, b in inputs]
    bad: list = []

    def worker(t):
        coeff, block = inputs[t]
        for _ in range(6):
            got = pl._transform_buffers_async(enc, coeff, list(block[0]))()
            if not all(np.array_equal(np.asarray(x), w)
                       for x, w in zip(got, wants[t])):
                bad.append(t)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert bad == []


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(STAND_INS))
def test_a_stand_in_for_k1_reaches_a_card_recover(monkeypatch, name):
    """On the card: a stand-in put in place of encoder_torch's K1 runs in
    a one-window recover's chain, piece by piece, so an altered K1 alters
    the recover's answer, as it does on the serial path; taken out, the
    chain is the native one again."""
    from seaweedfs_tpu_torch.ec import encoder_torch
    dev = card()
    enc = TorchEncoder(device=dev)
    coeff, block = recover_inputs(2, MIB + 7, seed=5)
    consts = torch.from_numpy(gf.bitplane_constants(coeff))
    want = per_piece(STAND_INS[name], consts, block,
                     g.piece_bounds(MIB + 7))
    real = encoder_torch.gf256_transform
    monkeypatch.setattr(encoder_torch, "gf256_transform",
                        lambda c, x, out=None: STAND_INS[name](real, c, x,
                                                               out))
    got = pl._transform_buffers_async(enc, coeff, list(block[0]))()
    assert np.array_equal(np.stack(got), want[0].numpy())
    monkeypatch.undo()
    got = pl._transform_buffers_async(enc, coeff, list(block[0]))()
    assert np.array_equal(np.stack(got),
                          np.stack(CpuEncoder()._apply(coeff,
                                                       list(block[0]))))
