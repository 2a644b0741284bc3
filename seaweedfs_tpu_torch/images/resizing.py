"""On-read image resizing.

Reference: weed/images/resizing.go:15-50 — `Resized(ext, data, width,
height, mode)` resizes png/jpg/gif on GET when `?width=&height=&mode=`
query params are present (hooked at
weed/server/volume_server_handlers_read.go:211-227). Modes (matching resizing.go's imaging calls):
  - ""     : when both dims given, stretch to exactly (w, h); with one
             dim, proportional scale to that dimension.
  - "fit"  : proportional fit within the (w, h) box.
  - "fill" : scale + center-crop so the image exactly fills (w, h).

A copy of seaweedfs_tpu/images/resizing.py in the PyTorch port.
"""

from __future__ import annotations

import io

_FORMATS = {
    "image/png": "PNG",
    "image/jpeg": "JPEG",
    "image/jpg": "JPEG",
    "image/gif": "GIF",
    "image/webp": "WEBP",
}


def resizable(mime: str) -> bool:
    return mime.lower() in _FORMATS


def resized(mime: str, data: bytes, width: int, height: int,
            mode: str = "") -> bytes:
    """Return the resized image bytes (same encoding as the input).

    Returns `data` unchanged when the mime type is not an image, the
    requested box is degenerate, or the image is already small enough.
    """
    fmt = _FORMATS.get(mime.lower())
    if fmt is None or (width <= 0 and height <= 0):
        return data
    try:
        from PIL import Image, ImageOps
    except ImportError:  # pragma: no cover - PIL is baked into the image
        return data
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception:
        return data
    ow, oh = img.size
    if width > 0 and height > 0:
        if ow <= width and oh <= height:
            return data
        if mode == "fill":
            img = ImageOps.fit(img, (width, height))
        elif mode == "fit":
            img.thumbnail((width, height))
        else:  # "": stretch to the exact box (imaging.Resize)
            img = img.resize((width, height))
    else:
        # single-dimension proportional scale
        if width > 0:
            if ow <= width:
                return data
            img = img.resize((width, max(1, round(oh * width / ow))))
        else:
            if oh <= height:
                return data
            img = img.resize((max(1, round(ow * height / oh)), height))
    out = io.BytesIO()
    if fmt == "JPEG" and img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    img.save(out, format=fmt)
    return out.getvalue()
