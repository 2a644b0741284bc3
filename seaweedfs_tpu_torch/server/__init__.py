"""server subpackage.

A copy of seaweedfs_tpu/server/__init__.py in the PyTorch port.
"""
