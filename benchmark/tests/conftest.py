"""The benchmark's own tests: CPU tests at a small size, and tests
marked `gpu` that decide inside a fixture whether there is a card."""

import pytest

from . import small


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips on a host without one "
        "(run on the card with -m gpu)")


@pytest.fixture
def small_root(tmp_path):
    return small.make(str(tmp_path))


@pytest.fixture
def cpu_port(monkeypatch):
    """The port's EC work on its plain PyTorch version, on the host, on
    one intra-op thread: several test workers each running the plain
    version on a pool of every core oversubscribe the host."""
    import torch
    monkeypatch.setenv("SWTPU_TORCH_EC_BACKEND", "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this host")
    return "cuda"
