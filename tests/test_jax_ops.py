"""Device ops (ops/jax_ops.py) against their numpy references.

Lifting + quantization and dequantization + inverse lifting are checked
against ops/lifting.py on random tile forests with missing leaves. The
f32 context math is checked against ops/prediction.contexts_np bit for
bit, including predictor parameters that are not f16 values (format v7
containers carry such parameters), where a fused multiply-add in place
of a rounded product would change results.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from frave_tpu.codec.options import EncoderQuality, quantization_matrix
from frave_tpu.ops import jax_ops as J
from frave_tpu.ops.lifting import (
    dequantize_np,
    forward_lifting_np,
    inverse_lifting_np,
    quantize_np,
)
from frave_tpu.ops.prediction import contexts_np


def _forest(depth: int, T: int, seed: int):
    """A geometry-shaped stand-in: T tiles of 2**depth leaves, ~15% of
    them out of bounds, the in-bounds ones mapped onto a 1-row image."""
    rng = np.random.default_rng(seed)
    n = 1 << depth
    leaf = rng.random((T, n)) > 0.15
    gather = np.full((T, n), -1, np.int64)
    gather[leaf] = rng.permutation(int(leaf.sum()))
    node = np.zeros((T, n), bool)  # presence of heap node q (q >= 1)
    node[:, 0] = leaf.any(axis=1)
    for level in range(depth):
        span = 1 << (depth - level)
        under = leaf.reshape(T, 1 << level, span).any(axis=2)
        node[:, 1 << level : 2 << level] = under
    geo = types.SimpleNamespace(
        height=1, width=int(leaf.sum()), depth=depth, num_tiles=T,
        nodes_per_tile=n, pixel_gather=gather, coef_mask=node,
    )
    pixels = rng.integers(0, 256, (3, geo.width)).astype(np.int64)
    return geo, pixels


def _qdiv(qm, depth):
    layers = np.floor(np.log2(np.arange(1 << depth) + 1)).astype(np.int64)
    return jnp.asarray(qm[layers].astype(np.int32))


@pytest.mark.parametrize("depth,T", [(9, 130), (7, 64)])
@pytest.mark.parametrize("quality", ["LOSSLESS", "LOW"])
def test_forward_lift_quantize_matches_numpy(depth, T, quality):
    geo, pixels = _forest(depth, T, seed=depth)
    qm = quantization_matrix(EncoderQuality[quality])
    want = quantize_np(forward_lifting_np(pixels, geo), qm, geo)
    mask = geo.pixel_gather >= 0
    leaves = np.where(mask[None], pixels[:, np.clip(geo.pixel_gather, 0, None)], 0)
    got = J.quantize(
        J.forward_lifting(jnp.asarray(leaves, jnp.int32), jnp.asarray(mask)[None], depth),
        _qdiv(qm, depth)[None, None, :],
    )
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("depth,T", [(9, 130), (7, 64)])
@pytest.mark.parametrize("quality", ["LOSSLESS", "LOW"])
def test_dequantize_inverse_lift_matches_numpy(depth, T, quality):
    geo, pixels = _forest(depth, T, seed=depth + 1)
    qm = quantization_matrix(EncoderQuality[quality])
    qcoef = quantize_np(forward_lifting_np(pixels, geo), qm, geo)
    want = inverse_lifting_np(dequantize_np(qcoef, qm, geo), geo)
    mask = geo.pixel_gather >= 0
    leaves = J.inverse_lifting(
        J.dequantize(jnp.asarray(qcoef), _qdiv(qm, depth)[None, None, :]),
        depth,
        jnp.asarray(geo.coef_mask)[None],
        jnp.asarray(mask)[None],
    )
    got = np.zeros_like(want)
    got[:, geo.pixel_gather[mask]] = np.clip(np.asarray(leaves)[:, mask], 0, 255)
    np.testing.assert_array_equal(got, want)
    if quality == "LOSSLESS":
        np.testing.assert_array_equal(got, pixels)


def check_contexts_match_numpy(f16_params: bool, onehot: bool) -> None:
    """J.contexts on the default device against contexts_np, bit exact."""
    rng = np.random.default_rng(3)
    n, F = 1 << 16, 8
    vals = rng.integers(-767, 768, (n, 6)).astype(np.int32)
    vals[: n // 8, 3:] = vals[: n // 8, :3]  # flat neighbourhoods
    lf = rng.random(n) < 0.2
    group = rng.integers(0, F, n).astype(np.int32)
    vp = rng.normal(0, 0.4, (F, 6)).astype(np.float32)
    wp = np.abs(rng.normal(0, 2.0, (F, 6))).astype(np.float32)
    if f16_params:
        vp = vp.astype(np.float16).astype(np.float32)
        wp = wp.astype(np.float16).astype(np.float32)
    bj, pj = jax.jit(functools.partial(J.contexts, onehot_params=onehot))(
        jnp.asarray(vals), jnp.asarray(lf), jnp.asarray(group),
        jnp.asarray(vp), jnp.asarray(wp),
    )
    bn, pn = contexts_np(vals, lf, group, vp, wp)
    np.testing.assert_array_equal(np.asarray(bj), bn)
    np.testing.assert_array_equal(np.asarray(pj), pn)


@pytest.mark.parametrize("onehot", [False, True])
@pytest.mark.parametrize("f16_params", [True, False])
def test_context_math_matches_numpy(f16_params, onehot):
    check_contexts_match_numpy(f16_params, onehot)


def test_split_params_is_exact_with_12_bit_halves():
    rng = np.random.default_rng(5)
    p = np.concatenate([
        rng.normal(0, 3.0, 4096).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.5, 65504.0, 1e-30], np.float32),
    ])
    hl = np.asarray(J.split_params(jnp.asarray(p)[:, None])[:, :, 0])
    hi, lo = hl[:, 0], hl[:, 1]
    np.testing.assert_array_equal(hi + lo, p)
    for part in (hi, lo):
        _, mant = np.frexp(part.astype(np.float64))
        # at most 12 significant bits: mant * 2**12 is an integer
        np.testing.assert_array_equal(mant * 4096, np.round(mant * 4096))
