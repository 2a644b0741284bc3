"""Image handling on upload and read.

A copy of seaweedfs_tpu/images/ in the PyTorch port.
"""

from .resizing import resized  # noqa: F401
from .orientation import fix_jpeg_orientation  # noqa: F401
