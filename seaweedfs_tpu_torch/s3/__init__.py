"""s3 subpackage of the PyTorch port (a copy of seaweedfs_tpu/s3/)."""
