"""EXIF orientation normalization on JPEG upload.

Reference: weed/images/orientation.go `FixJpgOrientation` — applied in
needle upload parsing (weed/storage/needle/needle.go ParseUpload) so
stored bytes render upright everywhere.

A copy of seaweedfs_tpu/images/orientation.py in the PyTorch port.
"""

from __future__ import annotations

import io


def fix_jpeg_orientation(data: bytes) -> bytes:
    """Bake the EXIF orientation into the pixel data of a JPEG.

    Returns the input unchanged when it is not a JPEG, carries no
    orientation tag (or orientation 1), or cannot be decoded.
    """
    if len(data) < 4 or data[:2] != b"\xff\xd8":
        return data
    try:
        from PIL import Image, ImageOps
    except ImportError:  # pragma: no cover
        return data
    try:
        img = Image.open(io.BytesIO(data))
        exif = img.getexif()
        orientation = exif.get(0x0112, 1)
        if orientation == 1:
            return data
        fixed = ImageOps.exif_transpose(img)
        out = io.BytesIO()
        fixed.save(out, format="JPEG", quality=95)
        return out.getvalue()
    except Exception:
        return data
