"""security subpackage.

A copy of seaweedfs_tpu/security/__init__.py in the PyTorch port.
"""
