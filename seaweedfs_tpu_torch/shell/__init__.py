"""shell subpackage.

A copy of seaweedfs_tpu/shell/__init__.py in the PyTorch port.
"""
