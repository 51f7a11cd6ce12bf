"""The port's JPEG decoder and image transform (``data/jpeg.py``,
``data/images.py``) against PIL and the JAX package, on the CPU.

PIL (which decodes with libjpeg's defaults) is imported here only; the port
depends on nothing beyond numpy and torch. Every comparison is exact (max
|diff| 0): the 18 fixture frames (baseline 4:2:0, 256 x 192) decoded, the
bicubic resize at up- and down-scales, ``b5_transform`` against the JAX
package's (PIL resize, float32 normalisation) and ``load_full_image_data``
of every scan with frames. Re-encoded frames cover 4:4:4, restart markers,
odd sizes and greyscale; a progressive file and 4:2:2 sampling raise and
name what they are.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from or4d_tpu.data import images as jimages

from or4d_tpu_torch.data import images
from or4d_tpu_torch.data.jpeg import JpegError, decode_jpeg, read_jpeg

ROOT = Path(__file__).parent / "golden" / "real_data"
FRAMES = sorted(ROOT.glob("export_holistic_take*_processed/colorimage/*.jpg"))


def test_the_fixture_has_18_baseline_420_frames():
    assert len(FRAMES) == 18
    for f in FRAMES:
        im = Image.open(f)
        assert im.size == (256, 192) and not im.info.get("progressive")


@pytest.mark.parametrize("path", FRAMES, ids=lambda p: p.name)
def test_decoder_equals_pil_on_the_fixture(path):
    got = read_jpeg(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _reencode(**kw) -> bytes:
    base = np.asarray(Image.open(FRAMES[0]).convert("RGB")).astype(np.int64)
    noise = np.random.default_rng(0).integers(-20, 20, (181, 237, 3))
    img = Image.fromarray(np.clip(base[:181, :237] + noise, 0, 255).astype(np.uint8))
    if kw.pop("grey", False):
        img = img.convert("L")
    buf = io.BytesIO()
    img.save(buf, "JPEG", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kw", [dict(quality=90, subsampling=0), dict(quality=75, subsampling=2),
                                dict(quality=95, subsampling=2, restart_marker_blocks=3),
                                dict(quality=50, subsampling=0, restart_marker_rows=1),
                                dict(quality=100, subsampling=2), dict(quality=85, grey=True)],
                         ids=["444", "420", "420_rst_blocks", "444_rst_rows", "420_q100", "grey"])
def test_decoder_equals_pil_on_reencoded_frames(kw):
    data = _reencode(**kw)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_jpeg(data).numpy(), want)


@pytest.mark.parametrize("kw,what", [(dict(progressive=True), "progressive"),
                                     (dict(subsampling=1), "4:4:4 and 4:2:0")])
def test_decoder_refuses_what_it_does_not_take(kw, what):
    with pytest.raises(JpegError, match=what):
        decode_jpeg(_reencode(**kw))
    with pytest.raises(JpegError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n")


@pytest.mark.parametrize("size", [(651, 488), (100, 60), (37, 300), (256, 97)])
def test_bicubic_resize_equals_pil(size):
    pil = Image.open(FRAMES[3]).convert("RGB")
    want = np.asarray(pil.resize(size, Image.BICUBIC))
    got = images.resize_bicubic(torch.from_numpy(np.asarray(pil).copy()), *size)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("path", FRAMES, ids=lambda p: p.name)
def test_b5_transform_equals_jax(path):
    want = jimages.b5_transform(Image.open(path).convert("RGB"))
    got = images.b5_transform(read_jpeg(path))
    assert got.dtype == torch.float32 and tuple(got.shape) == (456, 456, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("take,pcd", [(1, "000000"), (1, "000001"), (4, "000000")])
def test_full_image_data_equals_jax(take, pcd):
    want = jimages.load_full_image_data(ROOT, take, pcd, image_size=96)
    got = images.load_full_image_data(ROOT, take, pcd, image_size=96)
    assert tuple(got.shape) == (6, 96, 96, 3)
    np.testing.assert_array_equal(got.numpy(), want)
