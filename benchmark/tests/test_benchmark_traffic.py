"""The traffic and the data are the same for the same seed."""

import json
import os

import numpy as np
import pytest

from benchmark import data
from benchmark.ops import get

from .small import ROOT


def config(name):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        return json.load(f)


def layout(plans):
    return [[(p.nid, p.size, p.start) for p in v.parts] for v in plans]


@pytest.mark.parametrize("volume_bytes", [256 << 20, (256 << 20) - 1])
def test_layout_is_the_configurations(volume_bytes):
    cfg = dict(config("s3parts-ec"), volume_bytes=volume_bytes)
    a = data.plan(cfg)
    assert layout(a) == layout(data.plan(cfg))
    size = cfg["part_bytes"]
    for v in a:
        assert {p.size for p in v.parts} == {size}
        used = v.nbytes + data.RECORD_OVERHEAD * len(v.parts) \
            + data.SUPER_BLOCK_BYTES
        assert used <= cfg["volume_bytes"] < used + size \
            + data.RECORD_OVERHEAD
    nids = [p.nid for v in a for p in v.parts]
    assert sorted(nids) == list(range(1, len(nids) + 1))


def test_bytes_and_cookies_follow_the_seed():
    cfg = dict(config("s3parts-ec"), volume_bytes=4 << 20, part_bytes=1 << 20)
    plans = data.plan(cfg)
    one = [data.volume_bytes(2 ** 33 + 1, p, "cpu") for p in plans]
    two = [data.volume_bytes(2 ** 33 + 1, p, "cpu") for p in plans]
    other = data.volume_bytes(2 ** 33 + 2, plans[0], "cpu")
    assert all(np.array_equal(a, b) for a, b in zip(one, two))
    assert not np.array_equal(one[0], other)
    data.cookies(plans, 7)
    first = [p.cookie for v in plans for p in v.parts]
    data.cookies(plans, 7)
    assert first == [p.cookie for v in plans for p in v.parts]
    data.cookies(plans, 8)
    assert first != [p.cookie for v in plans for p in v.parts]


def test_keys_follow_the_seed():
    seed = 2 ** 40 + 3

    def seq(c):
        k = get.Keys(150, data.rng(seed, data.STREAM_CLIENT, c))
        return [next(k) for _ in range(600)]

    assert seq(0) == seq(0)
    assert seq(0) != seq(1)
    assert all(0 <= i < 150 for i in seq(3))
    assert len(set(seq(2))) > 140


def test_samples_follow_the_seed_and_span_the_window():
    seed = 2 ** 40 + 5

    def kept(c, n):
        r = get.Reservoir(8, data.rng(seed, data.STREAM_SAMPLE, c))
        for i in range(n):
            r.offer(i)
        return r.kept

    assert kept(0, 4000) == kept(0, 4000)
    assert kept(0, 4000) != kept(1, 4000)
    assert kept(0, 5) == [0, 1, 2, 3, 4]
    # over many clients the sample is uniform over the whole window:
    # as many GETs drawn from its last quarter as from its first
    picks = [i for c in range(200) for i in kept(c, 400)]
    assert len(picks) == 200 * 8
    first = sum(i < 100 for i in picks)
    last = sum(i >= 300 for i in picks)
    assert 300 < first < 500 and 300 < last < 500
