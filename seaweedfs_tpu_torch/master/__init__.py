"""master subpackage.

A copy of seaweedfs_tpu/master/__init__.py in the PyTorch port.
"""
