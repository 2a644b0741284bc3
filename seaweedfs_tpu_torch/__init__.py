"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The port runs on an NVIDIA H100 and keeps the JAX package's layout, so
each module here has a counterpart of the same path under seaweedfs_tpu/:

- ec/        GF(256) field math, stripe locate math, the torch encoder,
             the stripe-batch engine and the volume <-> shard pipelines
- ops/       the hand-written CUDA GF(256) kernel, its build and wrapper
- models/    flagship device-resident steps (encode / rebuild / verify)
- parallel/  the multi-device EC mesh on torch.distributed
- storage/   needle volumes, the store, the .idx/.ecx index format
- server/    the volume server (HTTP, the needle fast path, frames)
- security/, qos/, stats/, util/, images/, master/sequence.py
             the host modules the volume server runs on
- entry.py   entry points (entry, dryrun_multichip)
- cli.py     `python -m seaweedfs_tpu_torch.cli volume ...`

Importing the package builds and loads nothing and creates no process
group: the CUDA kernel is compiled at its first launch.
"""

__version__ = "0.1.0"
