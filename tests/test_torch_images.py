"""The port's images/: resize on read and the EXIF fix on upload, held to
the JAX package's images/ on the same bytes.

The image cases of tests/test_images_query.py (its query cases are in
tests/test_torch_query.py), pointed at the port's volume server. Reference behaviors: weed/images/resizing.go +
orientation.go (hooked at volume_server_handlers_read.go:211-227 /
needle.go ParseUpload).
"""

import io
import json

import pytest

from test_torch_cluster_util import Cluster, run

from seaweedfs_tpu_torch.images import fix_jpeg_orientation, resizing
from seaweedfs_tpu.images import fix_jpeg_orientation as ref_fix
from seaweedfs_tpu.images import resizing as ref_resizing

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


def _png(w, h, color=(255, 0, 0)):
    img = Image.new("RGB", (w, h), color)
    out = io.BytesIO()
    img.save(out, format="PNG")
    return out.getvalue()


# ---- pure-function tests ----

def test_resized_default_stretches_fit_proportional():
    data = _png(100, 50)
    # default mode stretches to the exact box (resizing.go imaging.Resize)
    img = Image.open(io.BytesIO(resizing.resized("image/png", data, 50, 50)))
    assert img.size == (50, 50)
    # fit is proportional within the box
    img = Image.open(io.BytesIO(
        resizing.resized("image/png", data, 50, 50, mode="fit")))
    assert img.size == (50, 25)


def test_resized_fill_crops():
    data = _png(100, 50)
    out = resizing.resized("image/png", data, 40, 40, mode="fill")
    img = Image.open(io.BytesIO(out))
    assert img.size == (40, 40)


def test_resized_single_dimension_and_noop():
    data = _png(100, 50)
    img = Image.open(io.BytesIO(resizing.resized("image/png", data, 50, 0)))
    assert img.size == (50, 25)
    # already small enough -> unchanged bytes
    assert resizing.resized("image/png", data, 200, 200) == data
    # non-image mime -> unchanged
    assert resizing.resized("text/plain", b"hello", 10, 10) == b"hello"


def test_fix_jpeg_orientation():
    img = Image.new("RGB", (40, 20), (0, 128, 255))
    out = io.BytesIO()
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 CW to display upright
    img.save(out, format="JPEG", exif=exif)
    fixed = fix_jpeg_orientation(out.getvalue())
    fimg = Image.open(io.BytesIO(fixed))
    assert fimg.size == (20, 40)  # rotated
    assert fimg.getexif().get(0x0112, 1) == 1
    # non-jpeg passes through
    png = _png(4, 4)
    assert fix_jpeg_orientation(png) == png


@pytest.mark.parametrize("w,h,mode", [(50, 50, ""), (50, 50, "fit"),
                                       (40, 40, "fill"), (50, 0, ""),
                                       (0, 20, ""), (200, 200, "")])
def test_resized_equals_reference(w, h, mode):
    data = _png(100, 50)
    assert resizing.resized("image/png", data, w, h, mode) == \
        ref_resizing.resized("image/png", data, w, h, mode)


def test_fix_jpeg_orientation_equals_reference():
    img = Image.new("RGB", (40, 20), (0, 128, 255))
    out = io.BytesIO()
    exif = Image.Exif()
    exif[0x0112] = 6
    img.save(out, format="JPEG", exif=exif)
    assert fix_jpeg_orientation(out.getvalue()) == ref_fix(out.getvalue())


# ---- server integration ----

def test_volume_server_resize_and_jpeg_upload(tmp_path):
    async def body():
        async with Cluster(str(tmp_path), n_servers=1) as c:
            # image upload + resized read
            a = await c.assign()
            png = _png(64, 32)
            async with c.http.post(
                    f"http://{a['url']}/{a['fid']}", data=png,
                    headers={"Content-Type": "image/png"}) as resp:
                assert resp.status == 201
            async with c.http.get(
                    f"http://{a['publicUrl']}/{a['fid']}",
                    params={"width": "32", "height": "32",
                            "mode": "fit"}) as resp:
                assert resp.status == 200
                img = Image.open(io.BytesIO(await resp.read()))
                assert img.size == (32, 16)
            # bad width param: serve original, not 500
            async with c.http.get(
                    f"http://{a['publicUrl']}/{a['fid']}",
                    params={"width": "abc"}) as resp:
                assert resp.status == 200
                assert await resp.read() == png
            # a JPEG upload is stored with its EXIF orientation baked in
            img = Image.new("RGB", (40, 20), (0, 128, 255))
            out = io.BytesIO()
            exif = Image.Exif()
            exif[0x0112] = 6
            img.save(out, format="JPEG", exif=exif)
            a2 = await c.assign()
            async with c.http.post(
                    f"http://{a2['url']}/{a2['fid']}", data=out.getvalue(),
                    headers={"Content-Type": "image/jpeg"}) as resp:
                assert resp.status == 201
            st, got = await c.get(a2["fid"], a2["publicUrl"])
            assert st == 200 and got == ref_fix(out.getvalue())
            assert Image.open(io.BytesIO(got)).size == (20, 40)
    run(body())
