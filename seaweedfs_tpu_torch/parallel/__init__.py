"""Multi-device EC on torch.distributed (the port of seaweedfs_tpu/parallel).

Importing this package creates no process group and builds nothing.
"""
