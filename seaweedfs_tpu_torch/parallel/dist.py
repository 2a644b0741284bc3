"""Process groups for the port's multi-device paths.

JAX needs no process group: one controller sees every device through
`jax.devices()`. On torch.distributed each device has its own process
(a rank), and the ranks meet in a process group before a DeviceMesh can
be laid over them. This module makes that group and starts ranks:

- `init(device=None, init_method=None)`: a context manager that joins
  the default process group (NCCL for "cuda", the default; gloo for
  "cpu"), yields this rank's device, and destroys the group on exit.
- `launch(n, argv, timeout)`: runs `python argv...` as ranks 0..n-1 of
  one host and returns their exit codes.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

# the directory that holds the seaweedfs_tpu_torch package, which ranks
# started by launch() must be able to import
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@contextlib.contextmanager
def init(device=None, init_method: str | None = None):
    """Join the default process group and yield this rank's device.

    The rank, world size and local rank come from RANK, WORLD_SIZE and
    LOCAL_RANK (LOCAL_RANK defaults to RANK). The rendezvous is
    `init_method`; without one it is "env://" where WORLD_SIZE is set,
    else a group of one is made over a file:// rendezvous in a fresh
    temporary directory, removed on exit. On "cuda" each rank takes
    cuda:LOCAL_RANK, and a host without a card raises: nothing falls
    back to gloo on the CPU."""
    dev_type = torch.device("cuda" if device is None else device).type
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "false; pass device='cpu' for a gloo group on the CPU")
        backend = "nccl"
    elif dev_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {device}")
    if dist.is_initialized():
        raise RuntimeError("this process already belongs to a process group")
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    tmp = None
    if init_method is None:
        if "WORLD_SIZE" in os.environ:
            init_method = "env://"
        else:
            tmp = tempfile.mkdtemp(prefix="swtpu-rdzv-")
            init_method = "file://" + os.path.join(tmp, "rdzv")
    try:
        if backend == "nccl":
            if local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local_rank} but only "
                    f"{torch.cuda.device_count()} CUDA devices are visible")
            torch.cuda.set_device(local_rank)
            local = torch.device("cuda", local_rank)
        else:
            local = torch.device("cpu")
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
        try:
            yield local
        finally:
            dist.destroy_process_group()
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def launch(n: int, argv: list[str], timeout: float = 120.0) -> list[int]:
    """Run `python argv...` as ranks 0..n-1 (RANK, LOCAL_RANK, WORLD_SIZE
    set, the package importable) and return their exit codes.

    As torchrun does, each rank gets OMP_NUM_THREADS=1 unless the caller
    set it: n ranks of one host would otherwise each start a CPU thread
    per core. When a rank fails, the others are killed: they would wait
    for it in a collective. Raises TimeoutError, after killing every
    rank, when they have not all ended within `timeout` seconds."""
    path = os.environ.get("PYTHONPATH")
    base = dict(os.environ, WORLD_SIZE=str(n),
                PYTHONPATH=_ROOT if not path else _ROOT + os.pathsep + path)
    base.setdefault("OMP_NUM_THREADS", "1")
    procs: list[subprocess.Popen] = []
    try:
        for r in range(n):
            env = dict(base, RANK=str(r), LOCAL_RANK=str(r))
            procs.append(subprocess.Popen([sys.executable, *argv], env=env))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks did not end within {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return [p.returncode for p in procs]
