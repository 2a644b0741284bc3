"""seaweedfs_tpu_torch — the PyTorch/CUDA port of seaweedfs_tpu.

The port runs on an NVIDIA H100 and keeps the JAX package's layout, so
each module here has a counterpart of the same path under seaweedfs_tpu/:

- ec/        GF(256) field math, stripe locate math, the torch encoder,
             the stripe-batch engine and the volume <-> shard pipelines
- ops/       the hand-written CUDA GF(256) kernel, its build and wrapper
- models/    flagship device-resident steps (encode / rebuild / verify)
- parallel/  the multi-device EC mesh on torch.distributed
- storage/   scalar types and the .idx/.ecx index format
- entry.py   entry points (entry, dryrun_multichip)

Importing the package builds and loads nothing and creates no process
group: the CUDA kernel is compiled at its first launch.
"""

__version__ = "0.1.0"
