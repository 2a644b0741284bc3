"""filer subpackage.

A copy of seaweedfs_tpu/filer/__init__.py in the PyTorch port.
"""
