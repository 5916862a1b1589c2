import numpy as np

from frave_tpu.utils import (
    get_prev_power_two,
    pack_signed,
    unpack_signed,
    trunc_div,
    floor_log2,
)


def test_prev_power_two():
    # reference utils.rs:5-14 semantics
    assert get_prev_power_two(0) == 0
    assert get_prev_power_two(1) == 1
    assert get_prev_power_two(2) == 2
    assert get_prev_power_two(3) == 2
    assert get_prev_power_two(1023) == 512
    assert get_prev_power_two(1024) == 1024


def test_pack_unpack_signed_roundtrip():
    k = np.arange(-512, 512)
    packed = pack_signed(k)
    assert packed.min() == 0 and packed.max() == 1023
    assert np.array_equal(unpack_signed(packed), k)
    # exact reference mapping: 0,-1,1,-2,2 -> 0,1,2,3,4
    assert pack_signed(np.asarray([0, -1, 1, -2, 2])).tolist() == [0, 1, 2, 3, 4]


def test_trunc_div_matches_rust():
    a = np.arange(-17, 17)
    # Rust i32 division truncates toward zero
    expected = np.asarray([int(x / 2) if x >= 0 else -((-int(x)) // 2) for x in a])
    assert np.array_equal(trunc_div(a, 2), expected)
    assert trunc_div(np.asarray(-7), 2) == -3
    assert trunc_div(np.asarray(7), 2) == 3
    assert trunc_div(np.asarray(-7), 3) == -2


def test_floor_log2():
    assert floor_log2(1) == 0
    assert floor_log2(2) == 1
    assert floor_log2(3) == 1
    assert floor_log2(1024) == 10

def test_f16_wire_round_matches_numpy():
    """J.f16_wire_round must reproduce numpy's f32->f16->f32 (IEEE RNE)
    bit-for-bit: format v8 wire params are f16 and encode-side residual
    math must use exactly the wire values. XLA's own f16 convert is not
    guaranteed IEEE RNE on every backend, hence the integer-op
    implementation under test."""
    import jax.numpy as jnp

    from frave_tpu.ops.jax_ops import f16_wire_round

    rng = np.random.default_rng(7)
    parts = [
        rng.standard_normal(4096).astype(np.float32)
        * rng.choice([1e-8, 1e-5, 1e-3, 1.0, 1e3, 6e4], 4096).astype(np.float32),
        # exact f16 ties (mantissa ..._10000000000000 in f32)
        np.asarray([1.0009765625, 1.0029296875, -1.0009765625], np.float32),
        # subnormal-range values incl. 2^-24 grid ties
        np.asarray([5.96e-8, 2.98e-8, -2.98e-8, 1e-7, 2 ** -25, 3 * 2 ** -26], np.float32),
        # overflow / max-f16 / zero / negative zero / inf
        np.asarray([65504.0, 65519.99, 65520.0, 1e9, -1e9, 0.0, -0.0, np.inf, -np.inf], np.float32),
    ]
    x = np.concatenate(parts)
    got = np.asarray(f16_wire_round(jnp.asarray(x)))
    want = x.astype(np.float16).astype(np.float32)
    assert np.array_equal(
        got.view(np.uint32), want.view(np.uint32)
    ), np.nonzero(got.view(np.uint32) != want.view(np.uint32))
    # NaN propagates as NaN
    assert np.isnan(np.asarray(f16_wire_round(jnp.asarray([np.nan], jnp.float32)))).all()
