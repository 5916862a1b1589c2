"""Device-side array ops: lifting, quantization, context prediction (JAX).

These mirror the numpy host oracle (frave_tpu/ops/lifting.py,
frave_tpu/ops/prediction.py) with *identical arithmetic semantics*:

  * integer lifting uses Rust truncated division (wavelet_transform.rs:
    211-218) implemented branch-free on int32;
  * context math (MED predictor, learned 6-tap predictors, width -> bucket
    LUT) is IEEE f32 elementwise with a fixed operation order — no
    reductions, so XLA cannot reorder anything, and every product is
    formed so that fused multiply-add contraction cannot change its
    rounding (contexts_hf) — so the encoder, the JAX decoder and the
    numpy decoder all agree bit-for-bit on every bucket and prediction
    (the self-consistency requirement of entropy_coding.rs:205-264,
    where decode re-derives encode's contexts).

Everything here is shape-static and jit-friendly; geometry arrives as
index tensors from frave_tpu/fractal/geometry.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

PRED_CLAMP = 255  # see frave_tpu/ops/prediction.py docstring

# width -> bucket edges — MUST match frave_tpu/entropy/tables.BUCKET_EDGES
# (the host/device twins are compared in tests)
from ..entropy.tables import BUCKET_EDGES as _BUCKET_EDGES


def trunc_div(a: jnp.ndarray, q) -> jnp.ndarray:
    """Rust-style truncated integer division (toward zero) on int32."""
    q = jnp.asarray(q, dtype=a.dtype)
    return jnp.where(a < 0, -((-a) // q), a // q)


def f16_wire_round(x: jnp.ndarray) -> jnp.ndarray:
    """f32 -> the IEEE-754 binary16 round-to-nearest-even value, as f32.

    Format v8 ships predictor parameters as f16 on the wire, and the
    encoder must form residuals with EXACTLY the wire values (the
    self-consistency contract of entropy_coding.rs:205-264). XLA's
    `astype(f16).astype(f32)` is not guaranteed to be IEEE f16 RNE on
    every backend (on one it was not, and an encode whose in-graph fits
    went through it produced undecodable streams because the host
    container then re-rounded the fetched params to real f16). So the
    rounding is done here with exact integer ops only:

      * normal f16 range (|x| >= 2^-14): RNE-truncate the f32 mantissa
        to 10 bits via the standard `+ 0xFFF + lsb` carry trick
        (mantissa overflow carries into the exponent, 65504 < |x| ->
        inf falls out of the same carry);
      * subnormal range (|x| < 2^-14): RNE onto the 2^-24 grid with an
        explicit mantissa shift (q = RNE(m >> (126 - e)), result
        q * 2^-24 — exact: q <= 1024 and 2^-24 is a normal f32). Pure
        integer ops — a float-trick version ((|x| + 0.5) - 0.5) can be
        algebraically simplified away by XLA;
      * NaN propagates, sign is reapplied bitwise (so -0 survives).
    """
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    sign = bits & jnp.uint32(0x80000000)
    absb = bits & jnp.uint32(0x7FFFFFFF)

    lsb = (absb >> jnp.uint32(13)) & jnp.uint32(1)
    rounded = (absb + jnp.uint32(0xFFF) + lsb) & jnp.uint32(0xFFFFE000)
    rounded = jnp.where(
        rounded >= jnp.uint32(0x47800000), jnp.uint32(0x7F800000), rounded
    )

    # subnormal: value = m * 2^(e-150), grid quantum 2^-24 -> shift by
    # 126 - e (f32-denormal inputs e=0 are < 2^-126, i.e. 0 on the grid)
    e = absb >> jnp.uint32(23)
    m = (absb & jnp.uint32(0x7FFFFF)) | jnp.uint32(0x800000)
    shift = jnp.clip(jnp.uint32(126) - e, jnp.uint32(1), jnp.uint32(31))
    half = jnp.uint32(1) << (shift - jnp.uint32(1))
    q = (m + half - jnp.uint32(1) + ((m >> shift) & jnp.uint32(1))) >> shift
    q = jnp.where(e == jnp.uint32(0), jnp.uint32(0), q)
    sub = q.astype(jnp.float32) * jnp.float32(2.0 ** -24)
    sub_bits = jax.lax.bitcast_convert_type(sub, jnp.uint32)

    out_abs = jnp.where(
        absb >= jnp.uint32(0x38800000), rounded, sub_bits
    )
    out = jnp.where(
        absb > jnp.uint32(0x7F800000), bits, sign | out_abs  # NaN passthrough
    )
    return jax.lax.bitcast_convert_type(out, jnp.float32)


def forward_lifting(leaves: jnp.ndarray, leaf_mask: jnp.ndarray, depth: int) -> jnp.ndarray:
    """Haar-style lifting, bottom-up (wavelet_transform.rs:179-225).

    leaves: [..., N] int32 leaf pixel values (N = 2**depth);
    leaf_mask: [..., N] bool in-bounds mask. Mask-aware: a single-child
    node codes difference 0 and passes the present value through (see
    ops/lifting.forward_lifting_np for the rationale vs the reference's
    read-as-0 semantics). Returns coefficients [..., N] int32; DC at 0.
    """
    n = 1 << depth
    assert leaves.shape[-1] == n
    coef_parts = [None] * (depth + 1)  # per-level slices, assembled at the end
    vals = leaves.astype(jnp.int32)
    mask = jnp.broadcast_to(leaf_mask, vals.shape)
    for level in range(depth - 1, -1, -1):
        L = vals[..., 0::2]
        R = vals[..., 1::2]
        Lm = mask[..., 0::2]
        Rm = mask[..., 1::2]
        l0 = jnp.where(Lm, L, 0)
        r0 = jnp.where(Rm, R, 0)
        both = Lm & Rm
        c = jnp.where(both, l0 - r0, 0)
        coef_parts[level] = c  # haar indices [2^level, 2^(level+1))
        vals = jnp.where(both, r0 + trunc_div(c, 2), l0 + r0)
        mask = Lm | Rm
    dc = jnp.where(mask[..., 0:1], vals[..., 0:1], 0)
    return jnp.concatenate([dc] + coef_parts[:depth], axis=-1)


def inverse_lifting(
    coef: jnp.ndarray,
    depth: int,
    node_mask: jnp.ndarray = None,
    leaf_mask: jnp.ndarray = None,
) -> jnp.ndarray:
    """Inverse lifting, top-down (extract_values, wavelet_transform.rs:358-381).

    coef: [..., N] int32; node_mask [..., N] bool (coefficient/node
    presence), leaf_mask [..., N] bool — the mask-aware mirror of
    forward_lifting (single-child nodes pass the low through). Returns
    leaf values [..., N] int32 (garbage at mask-false leaves — never
    scattered to pixels).
    """
    n = 1 << depth
    assert coef.shape[-1] == n
    vals = coef[..., 0:1]
    for level in range(depth):
        lo, hi = 1 << level, 1 << (level + 1)
        c = coef[..., lo:hi]
        if level == depth - 1:
            Lm = leaf_mask[..., 0::2]
            Rm = leaf_mask[..., 1::2]
        else:
            Lm = node_mask[..., 2 * lo : 2 * hi : 2]
            Rm = node_mask[..., 2 * lo + 1 : 2 * hi : 2]
        both = Lm & Rm
        right = jnp.where(both, vals - trunc_div(c, 2), vals)
        left = jnp.where(both, c + right, vals)
        # interleave (left, right) -> children order 2p, 2p+1
        vals = jnp.stack([left, right], axis=-1).reshape(
            coef.shape[:-1] + (2 * (hi - lo),)
        )
    return vals


def layer_divisors(qmatrix: jnp.ndarray, depth: int) -> jnp.ndarray:
    """Per-haar-index divisor, layer = floor(log2(i+1)) (quantization.rs:16)."""
    import numpy as np

    n = 1 << depth
    layers = np.floor(np.log2(np.arange(n, dtype=np.float64) + 1)).astype(np.int32)
    return jnp.asarray(qmatrix)[jnp.asarray(layers)]


def quantize(coef: jnp.ndarray, divisors: jnp.ndarray) -> jnp.ndarray:
    """Per-layer truncated divide (quantization.rs:7-25)."""
    return trunc_div(coef, divisors.astype(coef.dtype))


def dequantize(coef: jnp.ndarray, divisors: jnp.ndarray) -> jnp.ndarray:
    """Multiply back with midpoint bias (see dequantize_np rationale)."""
    q = divisors.astype(jnp.int32)
    c = coef.astype(jnp.int32)
    bias = jnp.sign(c) * ((q - 1) // 2)
    return c * q + bias


def assign_bucket_f32(width_f32: jnp.ndarray) -> jnp.ndarray:
    """Width -> context bucket: count of f32 edges <= width (NaN and
    negative widths -> bucket 0). Exact twin of
    frave_tpu/entropy/tables.assign_bucket."""
    w = jnp.where(jnp.isnan(width_f32), jnp.float32(0), width_f32)
    w = jnp.maximum(w, jnp.float32(0))
    bucket = jnp.zeros(w.shape, dtype=jnp.int32)
    for e in _BUCKET_EDGES:
        bucket = bucket + (w >= jnp.float32(e)).astype(jnp.int32)
    return bucket


def contexts(
    vals: jnp.ndarray,  # [..., 6] int32 neighbour values (0 where absent)
    lf: jnp.ndarray,  # [...] bool
    group: jnp.ndarray,  # [...] int32 parameter group 0/1/2
    vparams: jnp.ndarray,  # [3, 6] f32 (vmap over channels at call sites)
    wparams: jnp.ndarray,  # [3, 6] f32
    onehot_params: bool = False,
):
    """Context bucket + prediction per symbol — the exact f32 op sequence of
    contexts_np (frave_tpu/ops/prediction.py, reference prediction.rs:86-207).
    Returns (bucket [...] int32, pred [...] int32 clamped to +-255).

    onehot_params selects the per-symbol predictor rows with a one-hot
    einsum instead of a batched-index gather: inside the decode scan a
    batched gather has a fixed per-step cost whatever the table size,
    while the [*, num_fine] one-hot contraction is plain arithmetic.
    Exactness: exactly one term of the contraction is nonzero and
    Precision.HIGHEST keeps the contraction in f32 — a bf16- or
    TF32-truncated default lowering would corrupt f16 wire params.
    Encode paths keep the gather: ONE bulk gather over all K symbols is
    cheap."""
    v = vals.astype(jnp.int32)
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]

    # LF: LOCO-I/MED + |v0-v2| width
    mx = jnp.maximum(v0, v2)
    mn = jnp.minimum(v0, v2)
    med = jnp.where(v1 >= mx, mx, jnp.where(v1 <= mn, mn, v0 + v2 - v1))
    lf_bucket = assign_bucket_f32(jnp.abs(v0 - v2).astype(jnp.float32))

    # HF: learned width on 5 gradient features + bias; learned 6-tap value
    gi = group.astype(jnp.int32)
    # split the [F, 6] tables once; rows are selected from the split form
    vps, wps = split_params(vparams), split_params(wparams)  # [F, 2, 6]
    if onehot_params:
        oh = (
            gi[..., None] == jnp.arange(vparams.shape[0], dtype=jnp.int32)
        ).astype(jnp.float32)  # [..., F]
        _HI = jax.lax.Precision.HIGHEST
        vp = jnp.einsum("...f,fhx->...hx", oh, vps, precision=_HI)
        wp = jnp.einsum("...f,fhx->...hx", oh, wps, precision=_HI)
    else:
        vp = vps[gi]  # [..., 2, 6]
        wp = wps[gi]
    hf_bucket, hf_pred = contexts_hf(vals, vp, wp)

    bucket = jnp.where(lf, lf_bucket, hf_bucket)
    pred = jnp.where(lf, med, hf_pred)
    pred = jnp.clip(pred, -PRED_CLAMP, PRED_CLAMP)
    return bucket, pred


def split_params(p: jnp.ndarray) -> jnp.ndarray:
    """Predictor parameters [..., 6] f32 -> [..., 2, 6]: each p as
    (hi, lo) with p = hi + lo exactly and each part at most 12
    significant bits (hi keeps the top 12 bits of the f32 significand).
    Split the parameter tables or rows before the per-symbol work, which
    then needs only the two exact products of _rounded_product."""
    bits = jax.lax.bitcast_convert_type(p, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        bits & jnp.uint32(0xFFFFF000), jnp.float32
    )
    return jnp.stack([hi, p - hi], axis=-2)


def _rounded_product(x: jnp.ndarray, hi: jnp.ndarray, lo: jnp.ndarray):
    """f32 round(x * (hi + lo)) for integer-valued x with |x| < 2**11,
    immune to fused multiply-add contraction.

    XLA may contract `a * b + c` into one FMA (its CPU backend does),
    which skips the product's rounding; the numpy and C++ decoders
    round it.
    Here both partial products are exact (11 + 12 bits), so their sum
    rounds once to exactly the rounded full product, contracted or not,
    and the result is not a multiply that a following add could absorb."""
    return x * hi + x * lo


def contexts_hf(vals: jnp.ndarray, vp: jnp.ndarray, wp: jnp.ndarray):
    """HF context bucket + UNCLAMPED prediction with already-selected,
    split predictor rows (vp/wp from split_params, broadcastable to
    [..., 2, 6]) — the shared core of
    `contexts` and the segment decode path, where the parameter group is
    constant per schedule segment so no per-symbol selection is needed
    (prediction.rs:151-207).

    Every product goes through _rounded_product, so the sums equal the
    numpy twin's separately rounded products bit for bit on any backend.
    Tap values are bounded by 767 and gradients by 1534, inside its
    |x| < 2**11 contract. Format v8+ parameters are f16 values, whose
    products are exact anyway; v7 containers carry full f32 ones."""
    vf = vals.astype(jnp.float32)
    g1 = jnp.abs(vf[..., 0] - vf[..., 3])
    g2 = jnp.abs(vf[..., 1] - vf[..., 2])
    g3 = jnp.abs(vf[..., 4] - vf[..., 5])
    g4 = jnp.abs(vf[..., 1] - vf[..., 5])
    g5 = jnp.abs(vf[..., 2] - vf[..., 4])
    whi, wlo = wp[..., 0, :], wp[..., 1, :]
    hf_width = whi[..., 0] + wlo[..., 0]  # exact: the parameter itself
    for k, g in enumerate((g1, g2, g3, g4, g5), start=1):
        hf_width = hf_width + _rounded_product(g, whi[..., k], wlo[..., k])
    # flat-context rule — see ops/prediction.py (exact twin)
    gsum = g1 + g2 + g3 + g4 + g5
    hf_width = jnp.where(gsum == jnp.float32(0), jnp.float32(0), hf_width)
    hf_bucket = assign_bucket_f32(hf_width)
    vhi, vlo = vp[..., 0, :], vp[..., 1, :]
    hf_pred_f = _rounded_product(vf[..., 0], vhi[..., 0], vlo[..., 0])
    for k in range(1, 6):
        hf_pred_f = hf_pred_f + _rounded_product(
            vf[..., k], vhi[..., k], vlo[..., k]
        )
    # Rust `as i32` truncates; values beyond +-PRED_CLAMP collapse to the
    # clamp below, so a conservative pre-clip keeps f32->i32 conversion
    # well-defined without changing any in-range result.
    hf_pred = jnp.trunc(
        jnp.clip(jnp.where(jnp.isnan(hf_pred_f), 0.0, hf_pred_f), -1e9, 1e9)
    ).astype(jnp.int32)
    return hf_bucket, hf_pred


def contexts_static(
    vals: jnp.ndarray,  # [..., 6] int32 neighbour values (0 where absent)
    vp: jnp.ndarray,  # [6] f32 — the segment's predictor row
    wp: jnp.ndarray,  # [6] f32
    lf: bool,  # static: segment phase (parallel mode: always False)
):
    """`contexts` specialised for one schedule segment: lf and the
    parameter group are compile-time constants there (every wave of the
    parallel-mode schedule carries a single fine group id —
    fractal/schedule.py build_schedule), so the per-symbol one-hot
    parameter selection of the scan path disappears entirely."""
    if lf:
        v = vals.astype(jnp.int32)
        v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
        mx = jnp.maximum(v0, v2)
        mn = jnp.minimum(v0, v2)
        med = jnp.where(
            v1 >= mx, mx, jnp.where(v1 <= mn, mn, v0 + v2 - v1)
        )
        bucket = assign_bucket_f32(jnp.abs(v0 - v2).astype(jnp.float32))
        pred = med
    else:
        bucket, pred = contexts_hf(vals, split_params(vp), split_params(wp))
    return bucket, jnp.clip(pred, -PRED_CLAMP, PRED_CLAMP)


def gather_neighbours(coef_padded: jnp.ndarray, nbr_idx: jnp.ndarray) -> jnp.ndarray:
    """coef_padded: [..., n_slots + 1] int32 with the final slot pinned to 0;
    nbr_idx: [..., 6] int32 with -1 mapped to the padding slot by the caller
    (unwrap_or(0) semantics, context_modeling.rs:48,66)."""
    return coef_padded[..., nbr_idx]


def pack_signed(k: jnp.ndarray) -> jnp.ndarray:
    """Zig-zag i32 -> u32-as-i32 (utils.rs:34-40)."""
    return jnp.where(k >= 0, 2 * k, -2 * k - 1)


def unpack_signed(k: jnp.ndarray) -> jnp.ndarray:
    """Inverse zig-zag (utils.rs:42-48)."""
    return jnp.where(k % 2 == 0, k // 2, -((k + 1) // 2))
