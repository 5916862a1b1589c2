"""JAX compute-path tests: round trips + cross-backend agreement.

The correctness contract (README.md): lossless round trips are bit-exact,
and a bitstream produced by either backend decodes to identical pixels on
both backends (parameters and tables travel in the container; context math
is the same IEEE f32 op sequence everywhere).
"""

import numpy as np
import pytest

from frave_tpu import EncoderOptions, EncoderQuality, RasterImage, ColorSpace
from frave_tpu.codec.encoder import FRIEncoder
from frave_tpu.codec.decoder import FRIDecoder
from frave_tpu.codec.container import deserialize
from frave_tpu.codec.pipeline_np import decode_pipeline_np, encode_pipeline_np
from frave_tpu.codec.container import serialize


def _rand_image(h, w, c, seed):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, size=(h, w, c), dtype=np.uint8)
    cs = ColorSpace.LUMA if c == 1 else ColorSpace.RGB
    return RasterImage.from_array(arr, cs)


def _natural_image(h, w, c, seed):
    """Smooth gradient + low-amplitude noise: exercises the predictors."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        127
        + 90 * np.sin(xx / 17.0)[..., None]
        + 60 * np.cos(yy / 23.0)[..., None]
        + rng.normal(0, 4, size=(h, w, c))
    )
    arr = np.clip(base, 0, 255).astype(np.uint8)
    cs = ColorSpace.LUMA if c == 1 else ColorSpace.RGB
    return RasterImage.from_array(arr, cs)


@pytest.mark.parametrize(
    "h,w,c",
    [(32, 32, 1), (48, 32, 3), (100, 60, 1), (1, 1, 1), (7, 300, 1)],
)
def test_jax_lossless_roundtrip(h, w, c):
    img = _rand_image(h, w, c, seed=h * 1000 + w + c)
    enc = FRIEncoder(EncoderOptions(backend="jax"))
    data = enc.encode(img)
    out = FRIDecoder(backend="jax").decode(data)
    np.testing.assert_array_equal(out.data, img.data)


@pytest.mark.parametrize("h,w,c", [(64, 64, 1), (40, 56, 3)])
def test_cross_backend_jax_encode_np_decode(h, w, c):
    img = _natural_image(h, w, c, seed=7)
    data = FRIEncoder(EncoderOptions(backend="jax")).encode(img)
    out = FRIDecoder(backend="numpy").decode(data)
    np.testing.assert_array_equal(out.data, img.data)


@pytest.mark.parametrize("h,w,c", [(64, 64, 1), (40, 56, 3)])
def test_cross_backend_np_encode_jax_decode(h, w, c):
    img = _natural_image(h, w, c, seed=11)
    data = FRIEncoder(EncoderOptions(backend="numpy")).encode(img)
    out = FRIDecoder(backend="jax").decode(data)
    np.testing.assert_array_equal(out.data, img.data)


@pytest.mark.parametrize("quality", [EncoderQuality.HIGH, EncoderQuality.LOW])
def test_jax_lossy_decoders_agree(quality):
    """Lossy bitstreams must decode to the SAME pixels on both backends."""
    img = _natural_image(56, 72, 1, seed=13)
    data = FRIEncoder(EncoderOptions(backend="jax", quality=quality)).encode(img)
    out_jax = FRIDecoder(backend="jax").decode(data)
    out_np = FRIDecoder(backend="numpy").decode(data)
    np.testing.assert_array_equal(out_jax.data, out_np.data)
    # and the distortion must be bounded for a natural image
    mse = float(np.mean((out_jax.data.astype(np.float64) - img.data) ** 2))
    assert mse < 400.0


def test_jax_lossy_roundtrip_psnr_ordering():
    """Higher quality must not have worse PSNR (rate/PSNR sweep sanity,
    BASELINE.json config 2)."""
    img = _natural_image(64, 64, 1, seed=3)
    mses = {}
    sizes = {}
    for q in (EncoderQuality.LOSSLESS, EncoderQuality.HIGH, EncoderQuality.LOW):
        data = FRIEncoder(EncoderOptions(backend="jax", quality=q)).encode(img)
        out = FRIDecoder(backend="jax").decode(data)
        mses[q] = float(np.mean((out.data.astype(np.float64) - img.data) ** 2))
        sizes[q] = len(data)
    assert mses[EncoderQuality.LOSSLESS] == 0.0
    assert mses[EncoderQuality.HIGH] <= mses[EncoderQuality.LOW]
    assert sizes[EncoderQuality.LOW] <= sizes[EncoderQuality.HIGH] <= sizes[EncoderQuality.LOSSLESS]


def test_mixed_quality_batch_decode():
    """Regression (round-1 advisor high): a same-shape batch mixing
    quality levels must decode each image with ITS OWN quantization
    matrix — LOSSLESS stays bit-exact and every lossy image matches its
    solo decode exactly."""
    from frave_tpu.codec.pipeline_jax import decode_pipeline_jax_stream

    img = _natural_image(48, 48, 1, seed=21)
    qualities = [
        EncoderQuality.LOSSLESS,
        EncoderQuality.LOW,
        EncoderQuality.HIGH,
        EncoderQuality.MEDIUM,
    ]
    blobs = [
        FRIEncoder(EncoderOptions(backend="jax", quality=q)).encode(img)
        for q in qualities
    ]
    solo = [FRIDecoder(backend="jax").decode(b) for b in blobs]
    batch = decode_pipeline_jax_stream(
        [deserialize(b) for b in blobs], batch_size=4
    )
    np.testing.assert_array_equal(batch[0].data, img.data)  # lossless
    for s, b in zip(solo, batch):
        np.testing.assert_array_equal(s.data, b.data)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_external_predictor_params_roundtrip(backend):
    """EncoderOpts.value_prediction_params parity (encoder.rs:58-64): an
    encode with user-supplied parameters serializes them verbatim, still
    round-trips losslessly, and reproduces a pinned fit bit-for-bit."""
    img = _natural_image(48, 48, 1, seed=31)
    # pin the params a default encode fitted -> bitstreams must match
    base_blob = FRIEncoder(EncoderOptions(backend=backend)).encode(img)
    ci = deserialize(base_blob)
    vp = ci.channel_data[0].value_prediction_parameters
    wp = ci.channel_data[0].width_prediction_parameters
    pinned = FRIEncoder(
        EncoderOptions(
            backend=backend,
            value_prediction_params=vp,
            width_prediction_params=wp,
        )
    ).encode(img)
    assert pinned == base_blob
    # arbitrary external params: legacy [3, 6] rows are expanded to the
    # v8 per-level fine rows and serialized at the f16 wire precision
    my_vp = np.asarray(
        [[0.5, 0.2, 0.2, 0.05, 0.03, 0.02]] * 3, dtype=np.float32
    )
    blob = FRIEncoder(
        EncoderOptions(backend=backend, value_prediction_params=my_vp)
    ).encode(img)
    ci2 = deserialize(blob)
    from frave_tpu.fractal.schedule import get_schedule

    sched = get_schedule(48, 48)
    expect = sched.expand_params(my_vp).astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(
        ci2.channel_data[0].value_prediction_parameters, expect
    )
    out = FRIDecoder(backend=backend).decode(blob)
    np.testing.assert_array_equal(out.data, img.data)


def test_jax_verbose_metrics_per_context_entropy():
    """verbose/emit_coefficients observability on the jax path
    (prediction.rs:209-218,306-313 analog via the metrics sink)."""
    from frave_tpu.metrics import get_metrics

    m = get_metrics()
    m.reset()
    verbose0 = m.verbose
    img = _natural_image(48, 48, 1, seed=33)
    FRIEncoder(
        EncoderOptions(backend="jax", verbose=True, emit_coefficients=True)
    ).encode(img)
    snap = m.snapshot()
    assert any(k.startswith("encode/context_entropy_ch0_b") for k in snap)
    assert "encode/bpp" in snap
    assert any(
        m.arrays(f"encode/context_hist_ch0_b{b}") for b in range(15)
    )
    m.reset()
    m.verbose = verbose0


def test_jax_deterministic_bitstream():
    img = _rand_image(40, 40, 1, seed=5)
    d1 = FRIEncoder(EncoderOptions(backend="jax")).encode(img)
    d2 = FRIEncoder(EncoderOptions(backend="jax")).encode(img)
    assert d1 == d2


def test_batched_encode_decode():
    """Batched same-shape encode/decode: one dispatch + one fetch per batch."""
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax_batch,
        encode_pipeline_jax_batch,
    )
    from frave_tpu.codec.container import deserialize, serialize

    imgs = [_natural_image(48, 48, 1, seed=s) for s in range(5)]
    comp = encode_pipeline_jax_batch(imgs, EncoderOptions(backend="jax"))
    blobs = [serialize(c) for c in comp]
    outs = decode_pipeline_jax_batch([deserialize(b) for b in blobs])
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out.data, im.data)


def test_batched_matches_single_pixels():
    """Bitstream bytes may differ across batch sizes (XLA picks different
    f32 reduction orders for the predictor fit per program), but every
    stream must decode losslessly on any backend — decoded pixels are the
    contract (README.md)."""
    from frave_tpu.codec.pipeline_jax import encode_pipeline_jax_batch
    from frave_tpu.codec.container import serialize

    imgs = [_natural_image(40, 32, 1, seed=s) for s in range(3)]
    batched = [
        serialize(c)
        for c in encode_pipeline_jax_batch(imgs, EncoderOptions(backend="jax"))
    ]
    single = [FRIEncoder(EncoderOptions(backend="jax")).encode(im) for im in imgs]
    dec = FRIDecoder(backend="numpy")
    for bb, sb, im in zip(batched, single, imgs):
        np.testing.assert_array_equal(dec.decode(bb).data, im.data)
        np.testing.assert_array_equal(dec.decode(sb).data, im.data)


@pytest.mark.parametrize("mode", ["parity", "parallel"])
def test_modes_roundtrip_cross_backend(mode):
    img = _natural_image(48, 40, 3, seed=21)
    blob = FRIEncoder(EncoderOptions(backend="jax", mode=mode)).encode(img)
    for backend in ("jax", "numpy"):
        out = FRIDecoder(backend=backend).decode(blob)
        np.testing.assert_array_equal(out.data, img.data)


def test_parallel_mode_fewer_steps():
    from frave_tpu.fractal.schedule import get_lane_steps

    par = get_lane_steps(64, 64, 64, mode="parallel")
    ref = get_lane_steps(64, 64, 64, mode="parity")
    assert par.num_steps < ref.num_steps / 2


def test_stream_pipelined_roundtrip():
    """Host/device double-buffered stream APIs (the PP analog)."""
    from frave_tpu.codec.container import deserialize, serialize
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax_stream,
        encode_pipeline_jax_stream,
    )

    from frave_tpu.metrics import get_metrics

    get_metrics().reset()
    imgs = [_natural_image(32, 40, 1, seed=s) for s in range(10)]
    comp = encode_pipeline_jax_stream(imgs, EncoderOptions(backend="jax"), batch_size=4)
    assert len(comp) == 10
    blobs = [serialize(c) for c in comp]
    outs = decode_pipeline_jax_stream([deserialize(b) for b in blobs], batch_size=4)
    for im, out in zip(imgs, outs):
        np.testing.assert_array_equal(out.data, im.data)
    # profiling.stage_timer instruments the stream pipelines (SURVEY.md
    # section 5 tracing subsystem): 3 batches -> 3 samples per stage
    snap = get_metrics().snapshot()
    for stage in (
        "encode/dispatch",
        "encode/finish",
        "decode/dispatch",
        "decode/finish",
    ):
        assert len(snap[stage]) == 3, snap.keys()


def test_roundtrip_pipelined_stream():
    """Fully software-pipelined encode->bytes->decode with threaded
    fetch workers (the bench round-trip path)."""
    from frave_tpu.codec.container import deserialize
    from frave_tpu.codec.pipeline_jax import roundtrip_pipeline_jax_stream

    imgs = [_natural_image(32, 40, 1, seed=s) for s in range(10)]
    for n, bs in ((10, 4), (3, 8), (1, 8)):
        blobs, outs = roundtrip_pipeline_jax_stream(
            imgs[:n], EncoderOptions(backend="jax"), batch_size=bs
        )
        assert len(blobs) == n and len(outs) == n
        for im, out in zip(imgs[:n], outs):
            np.testing.assert_array_equal(out.data, im.data)
        # blobs are real containers (decodable independently)
        assert deserialize(blobs[0]).metadata == imgs[0].metadata


def test_channel_transform_stage():
    from frave_tpu.codec import channel_transform as ct

    img = _natural_image(16, 16, 3, seed=1)
    out, tid = ct.forward(img, "none")
    assert out is img and tid == ct.T_NONE
    assert ct.inverse(img, ct.T_NONE) is img
    t, tid = ct.forward(img, "auto")
    back = ct.inverse(t, tid)
    assert back.metadata.colorspace == ColorSpace.RGB
    np.testing.assert_array_equal(back.data, img.data)
    # strongly channel-correlated content must select a decorrelating
    # transform
    rng = np.random.default_rng(4)
    g = rng.integers(0, 256, size=(32, 32), dtype=np.uint8)
    corr = RasterImage.from_array(np.stack([g, g, g], axis=-1))
    _, tid2 = ct.forward(corr, "auto")
    assert tid2 in (ct.T_SUBGREEN, ct.T_YCOCG)
    # mod-256 wraparound cases are exactly invertible for every transform
    arr = np.asarray([[[255, 0, 255], [0, 255, 0]]], dtype=np.uint8)
    np.testing.assert_array_equal(ct.add_green(ct.subtract_green(arr)), arr)
    np.testing.assert_array_equal(ct.ycocg_inverse(ct.ycocg(arr)), arr)


def test_ycocg_exact_inverse_exhaustive_corners():
    from frave_tpu.codec import channel_transform as ct

    v = np.array([0, 1, 63, 127, 128, 129, 200, 254, 255], dtype=np.uint8)
    grid = np.stack(np.meshgrid(v, v, v, indexing="ij"), axis=-1).reshape(
        1, -1, 3
    )
    np.testing.assert_array_equal(ct.ycocg_inverse(ct.ycocg(grid)), grid)
    rng = np.random.default_rng(2)
    a = rng.integers(0, 256, size=(64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ct.ycocg_inverse(ct.ycocg(a)), a)


@pytest.mark.parametrize("transform", ["ycocg", "subtract-green"])
def test_rgb_transform_roundtrip_both_backends(transform):
    img = _natural_image(40, 56, 3, seed=29)
    for enc_b, dec_b in (("numpy", "jax"), ("jax", "numpy")):
        blob = FRIEncoder(
            EncoderOptions(backend=enc_b, color_transform=transform)
        ).encode(img)
        out = FRIDecoder(backend=dec_b).decode(blob)
        np.testing.assert_array_equal(out.data, img.data)


def test_rgb_subtract_green_improves_correlated_content():
    rng = np.random.default_rng(0)
    g = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    arr = np.stack([g, g, g], axis=-1)  # perfectly correlated channels
    b_on = FRIEncoder(EncoderOptions(backend="numpy")).encode(arr)
    b_off = FRIEncoder(
        EncoderOptions(backend="numpy", color_transform="none")
    ).encode(arr)
    assert len(b_on) < 0.6 * len(b_off)
    out = FRIDecoder(backend="numpy").decode(b_on)
    np.testing.assert_array_equal(out.data, arr)


def test_lossy_rgb_no_wrap_artifacts():
    """auto color transform must NOT apply under quantization (mod-256
    wraps would turn small coefficient errors into +-255 pixel errors)."""
    img = _natural_image(64, 64, 3, seed=17)
    blob = FRIEncoder(
        EncoderOptions(backend="numpy", quality=EncoderQuality.LOW)
    ).encode(img)
    out = FRIDecoder(backend="numpy").decode(blob)
    err = np.abs(out.data.astype(np.int32) - img.data.astype(np.int32))
    assert err.max() < 64


def test_lossy_rgb_clamped_transform_rate_win():
    """Lossy RGB's subtract-green uses the CLAMPED variant: bounded error
    (no mod-256 wraps) AND the decorrelation rate win on channel-
    correlated content."""
    yy, xx = np.mgrid[0:64, 0:64]
    g = np.clip(127 + 80 * np.sin(xx / 9.0) + 50 * np.cos(yy / 7.0), 0, 255)
    rng = np.random.default_rng(23)
    arr = np.clip(
        np.stack([g + 12, g, g - 9], axis=-1) + rng.normal(0, 2, (64, 64, 3)),
        0,
        255,
    ).astype(np.uint8)
    img = RasterImage.from_array(arr)
    q = EncoderQuality.MEDIUM
    b_on = FRIEncoder(
        EncoderOptions(backend="numpy", quality=q, color_transform="subtract-green")
    ).encode(img)
    b_off = FRIEncoder(
        EncoderOptions(backend="numpy", quality=q, color_transform="none")
    ).encode(img)
    assert len(b_on) < len(b_off)
    out = FRIDecoder(backend="numpy").decode(b_on)
    err = np.abs(out.data.astype(np.int32) - img.data.astype(np.int32))
    assert err.max() < 64


def test_legacy_wide_freq_bits_decode(monkeypatch):
    """Containers from pre-cap encoders may carry 13/14-bit contexts
    (ENC_FREQ_BITS_CAP landed at 12 in round 2); the jax decoder must
    keep accepting them via the 2**MAX_FREQ_BITS_CAP merged table
    (pipeline_jax.pick_lut_bits legacy branch). Emulate an old encoder
    by lifting the cap on the numpy backend, then decode with jax."""
    import frave_tpu.entropy.tables as T
    from frave_tpu.codec.pipeline_jax import pick_lut_bits
    from frave_tpu.ops.rans_jax import LUT_BITS

    monkeypatch.setattr(T, "ENC_FREQ_BITS_CAP", T.MAX_FREQ_BITS_CAP)
    img = _natural_image(192, 192, 1, seed=33)
    blob = FRIEncoder(EncoderOptions(backend="numpy")).encode(img)
    comp = deserialize(blob)
    bits = np.asarray(
        [c.max_freq_bits for ch in comp.channel_data if ch is not None
         for c in ch.ans_contexts]
    )
    assert bits.max() > 12, "fixture must exercise the wide-bits path"
    assert pick_lut_bits(bits) == LUT_BITS
    out = FRIDecoder(backend="jax").decode(blob)
    np.testing.assert_array_equal(out.data, img.data)


def test_flat_content_adaptive_lanes_single_pass():
    """ADVICE r4: flat content must get rate-adaptive lanes through the
    jax BATCH path (previously only FRIEncoder.encode, via a full numpy
    re-encode) — driven by the device-computed expected code length."""
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax,
        encode_pipeline_jax_batch,
    )

    flat = np.full((64, 96, 1), 77, dtype=np.uint8)
    im = RasterImage.from_array(flat, ColorSpace.LUMA)
    opts = EncoderOptions()
    ci = encode_pipeline_jax_batch([im], opts)[0]
    # est payload present, tiny; lanes shrunk to the rate-adaptive floor
    assert ci.est_payload_bytes is not None
    assert ci.est_payload_bytes < 1000.0
    from frave_tpu.fractal.schedule import default_num_lanes, get_schedule

    default = default_num_lanes(
        get_schedule(64, 96, mode=opts.mode).num_symbols
    )
    assert ci.num_lanes <= min(default, 256)
    assert np.array_equal(decode_pipeline_jax(ci).data, flat)

    # natural content keeps throughput-sized lanes (no re-encode)
    rng = np.random.default_rng(3)
    nat = rng.integers(0, 255, (64, 96, 1), dtype=np.uint8)
    ci2 = encode_pipeline_jax_batch(
        [RasterImage.from_array(nat, ColorSpace.LUMA)], opts
    )[0]
    assert ci2.est_payload_bytes > 1000.0
    assert np.array_equal(decode_pipeline_jax(ci2).data, nat)


def test_grid_encode_shift_planes_bit_exact(monkeypatch):
    """Round 5: the dense grid-mode encode (shift-plane taps, on-grid
    contexts — grid_decode.build_grid_encode) must produce BIT-IDENTICAL
    containers to the step-tensor statistics path when fit subsampling
    is disabled, for both context routes, gray and RGB."""
    import frave_tpu.codec.grid_decode as GD
    from frave_tpu.codec import pipeline_jax as P

    rng = np.random.default_rng(17)

    def enc(im, opts, **env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        P._program_cache.clear()
        GD._wavedev_cache.clear()
        try:
            ci = P.encode_pipeline_jax_batch([im], opts)[0]
            return serialize(ci), ci
        finally:
            for k in env:
                monkeypatch.delenv(k, raising=False)

    for c in (1, 3):
        px = np.clip(
            np.cumsum(rng.normal(0, 6, (96, 64, c)), axis=1) + 128, 0, 255
        ).astype(np.uint8)
        im = RasterImage.from_array(
            px, ColorSpace.LUMA if c == 1 else ColorSpace.RGB
        )
        opts = EncoderOptions(mode="grid", num_lanes=64)
        ref, _ = enc(im, opts, FRAVE_GRID_ENC="0")
        plane, ci = enc(
            im, opts, FRAVE_GRID_ENC="force", FRAVE_FIT_CAP="0",
            FRAVE_GRID_ENC_PLANECTX="1",
        )
        pack, _ = enc(
            im, opts, FRAVE_GRID_ENC="force", FRAVE_FIT_CAP="0",
            FRAVE_GRID_ENC_PLANECTX="0",
        )
        assert plane == ref and pack == ref
        # subsampled fit: wire parameters may move, must stay lossless
        sub, ci2 = enc(im, opts, FRAVE_GRID_ENC="force", FRAVE_FIT_CAP="512")
        from frave_tpu.codec.pipeline_jax import decode_pipeline_jax

        assert np.array_equal(decode_pipeline_jax(ci2).data, px)
    P._program_cache.clear()
    GD._wavedev_cache.clear()


def test_grid_compaction_variants_bit_exact(monkeypatch):
    """Round 5: sort-free grid-mode stream compaction (per-row u32 sort
    / prefix-scatter) must produce the identical wire as the global
    (rank, word) sort."""
    from frave_tpu.codec import pipeline_jax as P

    rng = np.random.default_rng(23)
    px = np.clip(
        np.cumsum(rng.normal(0, 8, (96, 128, 3)), axis=0) + 128, 0, 255
    ).astype(np.uint8)
    im = RasterImage.from_array(px, ColorSpace.RGB)
    opts = EncoderOptions(mode="grid", num_lanes=64)
    blobs = {}
    for mode in ("sort", "rows", "scatter"):
        monkeypatch.setenv("FRAVE_COMPACT", mode)
        P._program_cache.clear()
        ci = P.encode_pipeline_jax_batch([im], opts)[0]
        blobs[mode] = serialize(ci)
        assert np.array_equal(P.decode_pipeline_jax(ci).data, px)
    monkeypatch.delenv("FRAVE_COMPACT", raising=False)
    P._program_cache.clear()
    assert blobs["sort"] == blobs["rows"] == blobs["scatter"]
