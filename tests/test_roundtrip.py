"""Golden round-trip tests: decode(encode(x)) == x bit-exact for lossless.

This is the codec's central correctness contract (README.md: decoded
pixels bit-exact; the pipeline is lossless at LOSSLESS quality).
"""

import numpy as np
import pytest

from frave_tpu import (
    FRIDecoder,
    FRIEncoder,
    EncoderOptions,
    EncoderQuality,
)


def make_image(h, w, c, kind, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if kind == "smooth":
        base = 128 + 64 * np.sin(x / 7.0) + 48 * np.cos(y / 5.0)
        img = np.stack(
            [np.clip(base + 10 * k + rng.normal(0, 3, (h, w)), 0, 255) for k in range(c)],
            axis=-1,
        )
    elif kind == "noise":
        img = rng.integers(0, 256, size=(h, w, c))
    elif kind == "flat":
        img = np.full((h, w, c), 77)
    elif kind == "extremes":
        img = np.where((x + y) % 2 == 0, 0, 255)[:, :, None].repeat(c, axis=2)
    else:
        raise ValueError(kind)
    return img.astype(np.uint8)


@pytest.mark.parametrize("shape", [(16, 16), (17, 23), (32, 32), (31, 64)])
@pytest.mark.parametrize("kind", ["smooth", "noise", "flat", "extremes"])
def test_lossless_roundtrip_gray(shape, kind):
    img = make_image(*shape, 1, kind)
    enc = FRIEncoder(EncoderOptions(backend="numpy")).encode(img)
    dec = FRIDecoder(backend="numpy").decode(enc)
    assert np.array_equal(dec.data, img)


@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_lossless_roundtrip_rgb(kind):
    img = make_image(24, 40, 3, kind)
    enc = FRIEncoder(EncoderOptions(backend="numpy")).encode(img)
    dec = FRIDecoder(backend="numpy").decode(enc)
    assert np.array_equal(dec.data, img)
    assert dec.metadata.num_channels == 3


@pytest.mark.parametrize(
    "quality", [EncoderQuality.HIGH, EncoderQuality.MEDIUM, EncoderQuality.LOW]
)
def test_lossy_roundtrip_decodes_and_degrades_gracefully(quality):
    img = make_image(32, 32, 1, "smooth")
    enc = FRIEncoder(EncoderOptions(backend="numpy", quality=quality)).encode(img)
    dec = FRIDecoder(backend="numpy").decode(enc)
    mse = np.mean((dec.data.astype(float) - img.astype(float)) ** 2)
    # lossy modes must still decode deterministically and stay close
    limit = {EncoderQuality.HIGH: 2.0, EncoderQuality.MEDIUM: 8.0, EncoderQuality.LOW: 60.0}
    assert mse <= limit[quality]


def test_lossy_monotone_rate():
    img = make_image(32, 32, 1, "smooth")
    sizes = []
    for q in [EncoderQuality.LOSSLESS, EncoderQuality.HIGH, EncoderQuality.MEDIUM, EncoderQuality.LOW]:
        sizes.append(len(FRIEncoder(EncoderOptions(backend="numpy", quality=q)).encode(img)))
    assert sizes == sorted(sizes, reverse=True)


def test_deterministic_encoding():
    img = make_image(17, 19, 1, "smooth")
    opts = EncoderOptions(backend="numpy")
    assert FRIEncoder(opts).encode(img) == FRIEncoder(opts).encode(img)


def test_single_pixel_and_tiny_images():
    for shape in [(1, 1), (2, 3), (5, 5), (1, 64)]:
        img = make_image(*shape, 1, "smooth")
        enc = FRIEncoder(EncoderOptions(backend="numpy")).encode(img)
        dec = FRIDecoder(backend="numpy").decode(enc)
        assert np.array_equal(dec.data, img), shape


def test_rate_adaptive_lanes_flat_content():
    """Flat/graphic content shrinks the lane count (round 4): per-lane
    wire overhead (~2-4 B/lane/channel) must not dominate a tiny
    payload. Photo-like content keeps the throughput-sized default."""
    from frave_tpu.codec.container import deserialize
    from frave_tpu.fractal.schedule import default_num_lanes, get_schedule

    flat = make_image(256, 256, 1, "flat")
    enc = FRIEncoder(EncoderOptions(backend="numpy"))
    blob = deserialize(enc.encode(flat))
    default = default_num_lanes(get_schedule(256, 256).num_symbols)
    assert blob.num_lanes < default
    out = FRIDecoder(backend="numpy").decode(
        FRIEncoder(EncoderOptions(backend="numpy")).encode(flat)
    )
    np.testing.assert_array_equal(out.data, flat)

    noisy = make_image(256, 256, 1, "noise")
    blob2 = deserialize(enc.encode(noisy))
    assert blob2.num_lanes == default


def test_rate_adaptive_fallback_jax_backend():
    """The single-image jax encode falls back to the rate-adaptive
    numpy path when lane overhead dominates (FRIEncoder._lanes_dominate);
    the container stays losslessly decodable on both backends."""
    from frave_tpu.codec.container import deserialize

    flat = make_image(128, 96, 1, "flat")
    blob = FRIEncoder(EncoderOptions(backend="jax")).encode(flat)
    small = deserialize(blob).num_lanes
    pinned = FRIEncoder(
        EncoderOptions(backend="jax", num_lanes=512)
    ).encode(flat)
    assert small < deserialize(pinned).num_lanes
    assert len(blob) < len(pinned)
    for backend in ("numpy", "jax"):
        out = FRIDecoder(backend=backend).decode(blob)
        np.testing.assert_array_equal(out.data, flat)


def test_roundtrip_device_verify():
    """VERDICT r4 #4: bench-mode losslessness verified ON DEVICE (one
    scalar per batch, no pixel downlink) must agree with the host-side
    comparison and produce identical containers."""
    import numpy as np

    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec.pipeline_jax import roundtrip_pipeline_jax_stream

    rng = np.random.default_rng(31)
    corpus = [
        np.clip(
            np.cumsum(rng.normal(0, 5, (64, 64, c)), axis=1) + 128, 0, 255
        ).astype(np.uint8)
        for c in (1, 1, 3, 3)
    ]
    for px in corpus:
        imgs = [RasterImage.from_array(px)]
        opts = EncoderOptions(backend="jax")
        blobs, outs = roundtrip_pipeline_jax_stream(imgs, opts, batch_size=1)
        assert np.array_equal(outs[0].data, px)
        blobs2, mism = roundtrip_pipeline_jax_stream(
            imgs, opts, batch_size=1, device_verify=True
        )
        assert mism == 0
        assert blobs == blobs2
