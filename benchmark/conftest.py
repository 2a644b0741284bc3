"""pytest's set-up for the benchmark's tests. `tests/small.py` scales each
configuration under `configs/` to the part size it names for it; the
configurations added after it name theirs here."""

import pytest

from benchmark.tests import small

SMALL_PARTS = {"cluster4-ec": 128 << 10}


@pytest.fixture(autouse=True)
def _small_parts(monkeypatch):
    for name, size in SMALL_PARTS.items():
        monkeypatch.setitem(small.SMALL_PARTS, name, size)
