"""topology subpackage.

A copy of seaweedfs_tpu/topology/__init__.py in the PyTorch port.
"""
