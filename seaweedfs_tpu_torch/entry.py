"""Entry points of the port (the counterpart of __graft_entry__.py).

entry(device=None) — the flagship encode step (models/ec_model.py) and an
          example input on the device ("cuda" unless the caller asks for
          the CPU).
dryrun_multichip(n, device=None) — the distributed EC step (encode over
          the ("vol", "shard") mesh, rebuild with an all_gather over the
          shard axis, a rack encode with an uneven tail and a parity scrub
          with an all_reduce) on an n-rank mesh at tiny shapes, each
          checked against a numpy table oracle. It starts the n ranks
          itself: gloo on the CPU, NCCL where n cards are visible.

    python -m seaweedfs_tpu_torch.entry N [cpu|cuda]

runs dryrun_multichip(N) and exits non-zero when a check fails.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from .ec import gf
from .ec.encoder_torch import resolve_device
from .models import ec_model
from .parallel import dist as pdist
from .parallel import mesh as pmesh

LOST = (0, 11, 12, 13)
# seconds the dryrun's ranks may take in all before they are killed
_TIMEOUT_S = 120.0


def entry(device=None):
    """(step, example_args): the encode step of models/ec_model.py and a
    (10, 256 KiB) example input, both on `device`."""
    dev = resolve_device(device)
    step = ec_model.make_encode_step(device=dev)
    example = torch.from_numpy(ec_model.example_inputs(n=256 * 1024)).to(dev)
    return step, (example,)


def _oracle(data: np.ndarray) -> np.ndarray:
    """(10, n) data -> (14, n) shards by GF(256) table lookups: the same
    product as the kernel's bitplane form, computed another way."""
    coeff = gf.parity_matrix()
    parity = np.zeros((gf.PARITY_SHARDS, data.shape[1]), np.uint8)
    for r in range(gf.PARITY_SHARDS):
        for i in range(gf.DATA_SHARDS):
            parity[r] ^= gf.mul_table(int(coeff[r, i]))[data[i]]
    return np.concatenate([data, parity])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _dryrun_checks() -> str:
    """The checks of __graft_entry__.dryrun_multichip on the current
    process group; returns the summary line."""
    m = pmesh.make_mesh()
    vol_dim, shard_dim = m.shape
    batch = 2 * vol_dim
    n = 512 * shard_dim
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (batch, gf.DATA_SHARDS, n)).astype(np.uint8)

    encoded, rebuilt = pmesh.full_cycle_step(m, data, lost_rows=LOST)
    encoded, rebuilt = _host(encoded), _host(rebuilt)
    want = _oracle(data[0])
    _check(np.array_equal(encoded[0], want), "encoded volume 0 differs "
           "from the oracle")
    _check(np.array_equal(rebuilt[0], want[list(LOST)]), "rebuilt shards "
           f"{LOST} of volume 0 differ from the oracle")

    # rack-encode shape: more volumes than the vol axis, uneven tail
    rack = vol_dim * 2 + 3
    rack_data = rng.integers(0, 256,
                             (rack, gf.DATA_SHARDS, n)).astype(np.uint8)
    rack_enc = _host(pmesh.batched_encode(m, rack_data))
    _check(rack_enc.shape == (rack, gf.TOTAL_SHARDS, n),
           f"rack encode shape {rack_enc.shape}")
    for v in (0, rack - 1):
        _check(np.array_equal(rack_enc[v], _oracle(rack_data[v])),
               f"rack volume {v} differs from the oracle")

    scrub = _host(pmesh.batched_verify(m, encoded))
    _check(scrub.tolist() == [0] * batch, f"clean scrub {scrub}")
    corrupt = encoded.copy()
    corrupt[1, 0, 3] ^= 0xFF
    scrub2 = _host(pmesh.batched_verify(m, corrupt))
    _check(scrub2[1] > 0 and scrub2[0] == 0, f"corrupt scrub {scrub2}")
    return (f"dryrun_multichip: mesh {tuple(m.shape)} ('vol','shard') ok — "
            f"encoded {batch} volumes, rebuilt shards {LOST} via all_gather, "
            f"rack-encoded {rack} volumes (uneven tail), parity-scrubbed "
            f"{batch} volumes via shard-axis all_reduce")


def _rank_main(device: str, init_method: str, summary: str) -> None:
    with pdist.init(device, init_method):
        line = _dryrun_checks()
        if dist.get_rank() == 0:
            with open(summary, "w") as f:
                f.write(line)


def dryrun_multichip(n_devices: int, device=None) -> int:
    """Run the distributed EC step on an n_devices-rank mesh; prints the
    summary line and returns 0, or returns 1 when any rank failed."""
    dev_type = resolve_device(device).type
    if dev_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, "
                           f"{torch.cuda.device_count()} are visible")
    tmp = tempfile.mkdtemp(prefix="swtpu-dryrun-")
    try:
        summary = os.path.join(tmp, "summary")
        codes = pdist.launch(
            n_devices, ["-m", "seaweedfs_tpu_torch.entry", "--rank",
                        dev_type, "file://" + os.path.join(tmp, "rdzv"),
                        summary], _TIMEOUT_S)
        if any(codes) or not os.path.exists(summary):
            print(f"dryrun_multichip: ranks exited with {codes}",
                  file=sys.stderr)
            return 1
        with open(summary) as f:
            print(f.read())
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        _rank_main(*sys.argv[2:5])
    else:
        sys.exit(dryrun_multichip(int(sys.argv[1]),
                                  sys.argv[2] if len(sys.argv) > 2 else None))
