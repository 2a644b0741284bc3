"""Embedded filer store plugins.

A copy of seaweedfs_tpu/filer/stores/__init__.py in the PyTorch port.
"""
