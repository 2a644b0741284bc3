"""A copy of seaweedfs_tpu/query/__init__.py in the PyTorch port."""
from .json_query import Filter, query_json  # noqa: F401
