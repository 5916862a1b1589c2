"""Single-thread C reference baseline (csrc/refbase.cpp): the measured
stand-in for the Rust CLI (bench.py's vs_baseline). Contract: lossless round trip
on arbitrary uint8 images (refbase_roundtrip asserts pixel equality
internally) across shapes, channel counts, and the geometry-cache modes.
"""

import numpy as np
import pytest

from frave_tpu.native import have_native, refbase_roundtrip

pytestmark = pytest.mark.skipif(
    not have_native(), reason="native library unavailable"
)


@pytest.mark.parametrize(
    "h,w,c",
    [(32, 32, 1), (48, 32, 3), (100, 60, 1), (1, 1, 1), (7, 300, 1), (2, 511, 1)],
)
def test_refbase_lossless(h, w, c):
    rng = np.random.default_rng(h * 1000 + w + c)
    img = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
    te, td, nbytes = refbase_roundtrip(img)
    assert te > 0 and td > 0 and nbytes > 0


def test_refbase_natural_image_compresses():
    yy, xx = np.mgrid[0:128, 0:128]
    img = np.clip(
        127 + 80 * np.sin(xx / 19.0) + 60 * np.cos(yy / 13.0), 0, 255
    ).astype(np.uint8)[..., None]
    _, _, nbytes = refbase_roundtrip(img)
    assert nbytes < 128 * 128  # < 8 bpp on smooth content


def test_refbase_cache_modes_agree():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(40, 40, 1), dtype=np.uint8)
    _, _, n1 = refbase_roundtrip(img, cache_geometry=False)
    _, _, n2 = refbase_roundtrip(img, cache_geometry=True)
    _, _, n3 = refbase_roundtrip(img, cache_geometry=True)  # cache hit
    assert n1 == n2 == n3
