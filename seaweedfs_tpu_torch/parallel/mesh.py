"""Device-mesh parallelism for batched EC work, on torch.distributed.

The port of seaweedfs_tpu/parallel/mesh.py. The same shapes become a 2-D
DeviceMesh over the ranks of the default process group (parallel/dist.py):

  axis "vol"   — data parallel over independent volumes (a rack encode)
  axis "shard" — byte columns for encode and verify, and the shard rows
                 of each volume for rebuild

Encode runs with no collective. Rebuild all-gathers the present shard
rows over the "shard" axis (all_gather_into_tensor on its subgroup), and
each rank then rebuilds its own slice of byte columns. Verify all-reduces
the per-volume mismatch counts over "shard".

Placement is DTensor's: [Shard(0), Shard(2)] for encode and verify input
and for every output, [Shard(0), Shard(1)] for rebuild input; the
counterparts of P("vol", None, "shard") and P("vol", "shard", None). Each
rank computes on its local block through the hand-written CUDA kernel
(ops/gf256_cuda.gf256_stacked_transform, K2's port), or through its plain
version where the mesh is on the CPU.

Like JAX's, the public functions take the global (V, k, n) array, the
same on every rank, and return the global result on every rank. V is
zero-padded to the "vol" axis and n to 512 bytes per "shard" rank, so
that every rank's block has the same size (all_gather_into_tensor needs
that) and equals the JAX device's block; the padding is sliced off after.
The kernel itself needs no padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ec import gf
from ..ec.encoder_torch import device_consts
from ..ops.gf256_cuda import gf256_stacked_transform

# byte-column quantum per "shard" rank, as in the JAX package (one
# (1, 128) u32 lane row there)
_COL_QUANTUM = 512

_COLS = (Shard(0), Shard(2))  # P("vol", None, "shard")
_ROWS = (Shard(0), Shard(1))  # P("vol", "shard", None)


def mesh_shape(n: int, vol_axis: int | None = None) -> tuple[int, int]:
    """(vol, shard) axis sizes for n devices, by the JAX package's rule:
    the shard axis is the first of (2, 7, 14, 1) that divides n."""
    if vol_axis is None:
        for shard in (2, 7, 14, 1):
            if n % shard == 0 and shard <= n:
                vol_axis = n // shard
                break
    return vol_axis, n // vol_axis


def make_mesh(vol_axis: int | None = None) -> DeviceMesh:
    """2-D ("vol", "shard") DeviceMesh over every rank of the default
    process group, on the group's device type: "cuda" on NCCL, "cpu" on
    gloo."""
    world = dist.get_world_size()
    vol, shard = mesh_shape(world, vol_axis)
    if vol * shard != world:
        raise ValueError(f"a vol axis of {vol_axis} does not divide the "
                         f"{world} ranks of the process group")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (vol, shard),
                            mesh_dim_names=("vol", "shard"))


def _pad_axis(x: torch.Tensor, axis: int, quantum: int) -> torch.Tensor:
    size = x.shape[axis]
    padded = -(-size // quantum) * quantum
    if padded == size:
        return x
    shape = list(x.shape)
    shape[axis] = padded - size
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _as_uint8(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.uint8:
            raise TypeError(f"shards must be uint8, got {a.dtype}")
        return a
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8))


def _pad(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    vol, shard = mesh.shape
    return _pad_axis(_pad_axis(x, 0, vol), 2, _COL_QUANTUM * shard)


def _rank_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def _place(x: torch.Tensor, mesh: DeviceMesh, placements) -> DTensor:
    """The padded global x, the same on every rank, as a DTensor: each
    rank takes its own block (a view where x is on the rank's device), so
    no collective runs."""
    local = x
    for mesh_dim, p in enumerate(placements):
        step = x.shape[p.dim] // mesh.size(mesh_dim)
        local = local.narrow(p.dim, mesh.get_local_rank(mesh_dim) * step,
                             step)
    return DTensor.from_local(local.to(_rank_device(mesh)), mesh, placements)


def _global(out: DTensor, v: int, n: int | None = None) -> torch.Tensor:
    """The global result on every rank, padding sliced off."""
    full = out.full_tensor()
    return full[:v] if n is None else full[:v, :, :n]


def _check_row_split(k: int, shard: int) -> None:
    if k % shard:
        raise ValueError(f"{k} present shard rows do not split evenly over "
                         f"a shard axis of {shard}")


def _encode(mesh: DeviceMesh, x: torch.Tensor) -> DTensor:
    """x: padded (V, k, n) -> [Shard(0), Shard(2)] (V, k+m, n)."""
    d = _place(x, mesh, _COLS).to_local()  # (V/vol, k, n/shard)
    local = torch.empty((d.shape[0], gf.TOTAL_SHARDS, d.shape[2]),
                        dtype=torch.uint8, device=d.device)
    local[:, :gf.DATA_SHARDS] = d
    # parity straight into the output's rows: jnp.concatenate([d, parity])
    # with no parity buffer
    gf256_stacked_transform(device_consts(gf.parity_matrix(), d.device), d,
                            out=local[:, gf.DATA_SHARDS:])
    return DTensor.from_local(local, mesh, _COLS)


def batched_encode(mesh: DeviceMesh, data) -> torch.Tensor:
    """data: (V, k, n) uint8 -> (V, k+m, n) full shard sets.

    V is sharded over "vol" and the byte columns over "shard"; encode is
    columnwise independent, so no collective runs. A ragged V (a rack
    encode) and a ragged n are zero-padded, and the padding is sliced
    off."""
    data = _as_uint8(data)
    v, _, n = data.shape
    return _global(_encode(mesh, _pad(data, mesh)), v, n)


def _rebuild(mesh: DeviceMesh, rows: DTensor, present_rows, want_rows
             ) -> DTensor:
    """rows: [Shard(0), Shard(1)] padded (V, k, n) -> [Shard(0), Shard(2)]
    (V, len(want_rows), n)."""
    # the collective takes contiguous input; a row slice of V/vol > 1
    # volumes is not
    d = rows.to_local().contiguous()  # (V/vol, k/shard, n)
    shard = mesh.size(1)
    gathered = torch.empty((shard * d.shape[0],) + d.shape[1:],
                           dtype=torch.uint8, device=d.device)
    dist.all_gather_into_tensor(gathered, d, group=mesh.get_group("shard"))
    # gathered is rank-major, (shard, V/vol, k/shard, n): its k axis is no
    # single row stride, so this rank's column slice is rearranged into
    # (V/vol, k, n/shard) once (reshape copies unless it is a view)
    cols = d.shape[2] // shard
    c0 = mesh.get_local_rank("shard") * cols
    mine = (gathered.view(shard, *d.shape)[..., c0:c0 + cols]
            .movedim(0, 1).reshape(d.shape[0], -1, cols))
    coeff = gf.cached_shard_rows(tuple(want_rows), tuple(present_rows))
    out = gf256_stacked_transform(device_consts(coeff, d.device), mine)
    return DTensor.from_local(out, mesh, _COLS)


def batched_rebuild(mesh: DeviceMesh, present_rows: list[int], shards,
                    want_rows: list[int]) -> torch.Tensor:
    """shards: (V, k, n), the k present shard rows of V volumes (stacked in
    present_rows order), laid out across the "shard" axis; rebuild
    want_rows for every volume -> (V, len(want_rows), n).

    The rows are all-gathered over "shard", and each rank rebuilds its own
    slice of byte columns. A k that the shard axis does not divide raises
    ValueError before any collective."""
    k = len(present_rows)
    _check_row_split(k, mesh.shape[1])
    shards = _as_uint8(shards)
    v, kk, n = shards.shape
    if kk != k:
        raise ValueError(f"shards has {kk} rows, present_rows lists {k}")
    rows = _place(_pad(shards, mesh), mesh, _ROWS)
    return _global(_rebuild(mesh, rows, present_rows, want_rows), v, n)


def batched_verify(mesh: DeviceMesh, shards) -> torch.Tensor:
    """Distributed parity scrub: shards (V, k+m, n) -> (V,) int32
    mismatched-parity-byte counts (0 = stripe consistent).

    Every rank recomputes parity for its column slice from the strided
    data rows of its block (no copy), and one all_reduce over "shard"
    makes the per-volume counts global. Zero padding is parity-consistent,
    so it adds no mismatch."""
    shards = _as_uint8(shards)
    v, rows, _ = shards.shape
    if rows != gf.TOTAL_SHARDS:
        raise ValueError(f"shards must have {gf.TOTAL_SHARDS} rows, got "
                         f"{rows}")
    d = _place(_pad(shards, mesh), mesh, _COLS).to_local()
    parity = gf256_stacked_transform(
        device_consts(gf.parity_matrix(), d.device), d[:, :gf.DATA_SHARDS])
    bad = (parity != d[:, gf.DATA_SHARDS:]).sum(dim=(1, 2),
                                                 dtype=torch.int32)
    dist.all_reduce(bad, group=mesh.get_group("shard"))
    return _global(DTensor.from_local(bad, mesh, (Shard(0), Replicate())), v)


def full_cycle_step(mesh: DeviceMesh, data,
                    lost_rows: tuple[int, ...] = (0, 11, 12, 13)):
    """Encode a batch of volumes, then rebuild a worst-case loss pattern
    from the first 10 survivors; returns (encoded, rebuilt).

    The encoded shards stay column-sharded on their ranks; the survivors
    are re-placed row-sharded for the rebuild with one redistribute, not
    gathered onto every rank."""
    data = _as_uint8(data)
    v, _, n = data.shape
    present = [i for i in range(gf.TOTAL_SHARDS) if i not in lost_rows]
    use = present[:gf.DATA_SHARDS]
    _check_row_split(len(use), mesh.shape[1])
    encoded = _encode(mesh, _pad(data, mesh))
    survivors = DTensor.from_local(encoded.to_local()[:, use], mesh,
                                   _COLS).redistribute(mesh, _ROWS)
    rebuilt = _rebuild(mesh, survivors, use, list(lost_rows))
    return _global(encoded, v, n), _global(rebuilt, v, n)
