"""Codec checks that need the GPU.

The format is defined by two independent decoders, the numpy pipeline
(``codec/pipeline_np.py``) and the C++ ``csrc/frif.cpp``; containers
the GPU writes must decode bit-exactly on both, and theirs on the GPU.
XLA may contract ``a*b + c`` into fused multiply-adds, which those
decoders do not, so the f32 context math is also checked directly
against numpy on the GPU (tests/test_jax_ops.py).

Every test takes the ``gpu`` fixture and skips without a GPU. Run them
on a GPU machine with ``FRAVE_TEST_GPU=1 python -m pytest tests/ -m chip``.
"""

import os

import numpy as np
import pytest

import frave_tpu
from frave_tpu import EncoderOptions, EncoderQuality, RasterImage
from frave_tpu.codec.container import deserialize, serialize
from frave_tpu.codec.pipeline_jax import (
    decode_pipeline_jax_batch,
    encode_pipeline_jax_batch,
)
from frave_tpu.codec.pipeline_np import decode_pipeline_np, encode_pipeline_np
from frave_tpu.native import frif_decode_native, frif_encode_native

pytestmark = pytest.mark.chip

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN = ["v7_gray", "v7_rgb", "v8_gray", "v8_rgb", "v9grid_gray", "v9grid_rgb"]


def _natural(seed, h, w, c):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 5, (h, w, c)), axis=1)
    return np.clip(
        base + rng.normal(0, 4, (h, w, c)) + 128, 0, 255
    ).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3])
def test_gpu_and_cxx_cross_decode(gpu, channels):
    px = _natural(1, 256, 256, channels)
    blob = frave_tpu.encode(px, EncoderOptions(backend="jax"))
    np.testing.assert_array_equal(frif_decode_native(blob), px)
    cblob = frif_encode_native(px)
    out = frave_tpu.decode(cblob, backend="jax")
    np.testing.assert_array_equal(out.data, px)


@pytest.mark.parametrize("quality", ["LOSSLESS", "HIGH", "LOW"])
def test_gpu_and_numpy_cross_decode(gpu, quality):
    px = _natural(2, 256, 256, 3)
    im = RasterImage.from_array(px)
    q = EncoderQuality[quality]
    for ci in (
        encode_pipeline_jax_batch([im], EncoderOptions(backend="jax", quality=q))[0],
        encode_pipeline_np(im, EncoderOptions(backend="numpy", quality=q)),
    ):
        ci = deserialize(serialize(ci))
        want = decode_pipeline_np(ci).data
        np.testing.assert_array_equal(decode_pipeline_jax_batch([ci])[0].data, want)
        if q == EncoderQuality.LOSSLESS:
            np.testing.assert_array_equal(want, px)


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_container_on_gpu(gpu, name):
    with open(os.path.join(DATA, f"{name}.frv"), "rb") as f:
        blob = f.read()
    want = np.load(os.path.join(DATA, f"{name}.npy"))
    np.testing.assert_array_equal(frave_tpu.decode(blob, backend="jax").data, want)


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("f16_params", [True, False])
def test_context_math_matches_numpy(gpu, f16_params, onehot):
    from test_jax_ops import check_contexts_match_numpy

    check_contexts_match_numpy(f16_params, onehot)
