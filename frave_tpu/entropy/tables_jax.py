"""Device twin of the context-table pipeline (frave_tpu/entropy/tables.py).

Runs inside the fused encode program so the entire encode is ONE device
dispatch (shipping the histogram to the host for table building would
add a synchronizing round trip per batch). Property-tested for exact
integer equality against the host implementation: the decoder
regenerates tables on host from the wire fields (bits, off-list) and
rANS breaks on any 1-bit difference.

The Laplace pmf rows need f64, so they are precomputed on host for
every (bucket, bits) pair and passed in as a [CONTEXT_AMOUNT, 7, 1024]
u32 tensor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .tables import (
    ALPHABET_SIZE,
    CONTEXT_AMOUNT,
    ENC_FREQ_BITS_CAP,
    MAX_FREQ_BITS_CAP,
    MIN_FREQ_BITS,
    NUM_BITS_CHOICES,
)


def select_scales_device(
    hist: jnp.ndarray,
    grid_log2: jnp.ndarray,
    grid_zero: jnp.ndarray,
) -> jnp.ndarray:
    """Device twin of tables.select_scale: per-(..., context) Laplace-grid
    scale minimizing estimated code length + off-list wire cost.

    hist: [..., CA, 1024] i32; grid_log2: [NUM_SCALES, 7, 1024] f32
    (log2(max(row,1))); grid_zero: [NUM_SCALES, 7, 1024] f32 (row == 0).
    Returns scale_idx [..., CA] i32. Encode-only — the index travels on
    the wire, so this need not match the host's f32 ordering exactly."""
    h = hist.astype(jnp.float32)
    data = (hist > 0).astype(jnp.float32)
    total = jnp.sum(h, axis=-1)  # [..., CA]
    bits0 = jnp.full(total.shape, MIN_FREQ_BITS, jnp.int32)
    for k in range(MIN_FREQ_BITS + 1, ENC_FREQ_BITS_CAP + 1):
        bits0 = bits0 + (total >= (1 << k)).astype(jnp.int32)
    ohb = (
        (bits0 - MIN_FREQ_BITS)[..., None]
        == jnp.arange(NUM_BITS_CHOICES, dtype=jnp.int32)
    ).astype(jnp.float32)  # [..., CA, 7]
    # gains[..., c, g] = sum_a hist*log2row - 16*zeroed_data, at bits0
    # HIGHEST precision pins f32 math: with TF32 the chosen scales would
    # depend on the backend's default
    hi = jax.lax.Precision.HIGHEST
    gl = jnp.einsum("...ca,gba->...cgb", h, grid_log2, precision=hi)
    gz = jnp.einsum("...ca,gba->...cgb", data, grid_zero, precision=hi)
    gains = jnp.einsum(
        "...cgb,...cb->...cg", gl - 16.0 * gz, ohb, precision=hi
    )
    return jnp.argmax(gains, axis=-1).astype(jnp.int32)


def finalize_contexts_device(
    hist: jnp.ndarray,
    lap_rows: jnp.ndarray,
    bits0: jnp.ndarray = None,
    off_mask_in: jnp.ndarray = None,
    scale_idx: jnp.ndarray = None,
):
    """hist: [..., CA, 1024] int32 data histograms;
    lap_rows: [CONTEXT_AMOUNT, 7, 1024] u32 Laplace tables per (bucket,
    bits) — or, with scale_idx given, the full [NUM_SCALES, 7, 1024] grid
    indexed by scale_idx [..., CA] (format v9).

    Encode side: bits0/off_mask_in omitted — starting bits come from the
    histogram totals (context_from_histogram). Decode side: pass the wire
    bits and off-mask with an all-zero hist (context_from_wire) — the
    bits-bump loop is idempotent on already-bumped wire values.

    Returns (bits [..., CA] i32, freqs [..., CA, 1024] i32,
    cdf [..., CA, 1024] i32, off_mask [..., CA, 1024] bool) — exact twin
    of the host implementation."""
    h = hist.astype(jnp.int32)
    data_raw = h > 0  # [..., CA, 1024]
    # forced-to-1 set: data symbols plus the wire off-list (host
    # _fill_with_laplace semantics)
    data = data_raw if off_mask_in is None else (data_raw | off_mask_in)
    total = jnp.sum(h, axis=-1)  # [..., CA]

    if bits0 is None:
        # bits0 = clamp(bit_length(total) - 1, MIN, ENC cap) — the
        # encode side stays under ENC_FREQ_BITS_CAP (tables.py note);
        # only wire bits (decode side, branch below) may reach 14.
        bits0 = jnp.full(total.shape, MIN_FREQ_BITS, jnp.int32)
        for k in range(MIN_FREQ_BITS + 1, ENC_FREQ_BITS_CAP + 1):
            bits0 = bits0 + (total >= (1 << k)).astype(jnp.int32)
    else:
        bits0 = jnp.clip(bits0.astype(jnp.int32), MIN_FREQ_BITS, MAX_FREQ_BITS_CAP)

    lap = lap_rows.astype(jnp.int32)  # [CA or NUM_SCALES, 7, 1024]
    if scale_idx is not None:
        # v9: fold the per-(..., context) scale choice into a one-hot over
        # grid rows; contracted JOINTLY with the bits one-hot below so no
        # [..., CA, 7, 1024] intermediate ever materializes.
        ohg = (
            scale_idx[..., None]
            == jnp.arange(lap.shape[0], dtype=jnp.int32)
        ).astype(jnp.float32)  # [..., CA, G]
    lap_zero_f = (lap == 0).astype(jnp.float32)  # [G, 7, 1024]
    # Per-candidate-bits nonzero counts WITHOUT materializing the
    # [7, ..., CA, 1024] filled tensor: nnz(bits k) = nnz(laplace row k)
    # + |{data symbols where the row is 0}|. The data-dependent part is a
    # 1024-reduction -> one f32 einsum (exact: counts <= 1024 < 2^24)
    # that XLA maps onto a matrix unit instead of a 7x-wide elementwise
    # sweep. HIGHEST precision: at default precision the contraction may
    # run with bf16- or TF32-truncated inputs, and one-hot matvecs of
    # >8-bit values are then INEXACT; table bits must be exact or
    # streams break
    if scale_idx is None:
        lap_nnz = jnp.sum((lap > 0).astype(jnp.int32), axis=-1)  # [CA, 7]
        extra = jnp.einsum(
            "...ca,cka->...ck",
            data.astype(jnp.float32),
            lap_zero_f,
            precision=jax.lax.Precision.HIGHEST,
        )  # [..., CA, 7]
        nnz_all = lap_nnz + extra.astype(jnp.int32)  # [..., CA, 7]
    else:
        lap_nnz_f = jnp.sum(
            (lap > 0).astype(jnp.float32), axis=-1
        )  # [G, 7]
        lap_nnz = jnp.einsum(
            "...cg,gk->...ck",
            ohg,
            lap_nnz_f,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.int32)  # [..., CA, 7]
        ez = jnp.einsum(
            "...ca,gka->...cgk",
            data.astype(jnp.float32),
            lap_zero_f,
            precision=jax.lax.Precision.HIGHEST,
        )  # [..., CA, G, 7]
        extra = jnp.einsum(
            "...cgk,...cg->...ck",
            ez,
            ohg,
            precision=jax.lax.Precision.HIGHEST,
        )
        nnz_all = lap_nnz + extra.astype(jnp.int32)

    # sequential bump: b = bits0; while not ok(b) and b < 14: b += 1
    bits = bits0
    for k in range(MIN_FREQ_BITS, MAX_FREQ_BITS_CAP):
        ok_k = (1 << k) >= nnz_all[..., k - MIN_FREQ_BITS]
        bits = jnp.where((bits == k) & (~ok_k), k + 1, bits)

    sel = (bits - MIN_FREQ_BITS).astype(jnp.int32)  # [..., CA]
    # select each bucket's Laplace row at its chosen bits via a one-hot
    # contraction (exact in f32: row values <= 2^14) — again no
    # [..., 7, 1024] broadcast
    onehot = (
        sel[..., None] == jnp.arange(NUM_BITS_CHOICES, dtype=jnp.int32)
    ).astype(jnp.float32)  # [..., CA, 7]
    # HIGHEST precision — lap row values reach 2^14, far past bf16's
    # 8-bit mantissa; a truncated row here silently corrupts every
    # frequency table built on device (see `extra` note above)
    if scale_idx is None:
        lap_sel = jnp.einsum(
            "...ck,cka->...ca",
            onehot,
            lap.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.int32)  # [..., CA, 1024]
    else:
        # joint (scale, bits) one-hot [..., CA, G, 7] — contracting (g, k)
        # as one 7G-sized dimension keeps the peak intermediate at
        # [..., CA, G, 7] instead of [..., CA, G, 1024]
        ohgk = ohg[..., :, None] * onehot[..., None, :]
        lap_sel = jnp.einsum(
            "...cgk,gka->...ca",
            ohgk,
            lap.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.int32)  # [..., CA, 1024]
    filled = jnp.where(lap_sel > 0, lap_sel, jnp.where(data, 1, 0))
    off_mask = data_raw & (lap_sel == 0)
    if off_mask_in is not None:
        off_mask = off_mask | off_mask_in

    # --- largest-remainder normalization (tables._normalize_freqs twin)
    target = (jnp.int32(1) << bits).astype(jnp.int32)  # [..., CA]
    total2 = jnp.sum(filled, axis=-1)  # > 0 always (laplace rows nonzero)
    scaled = (filled * target[..., None]) // total2[..., None]
    s = jnp.where(filled > 0, jnp.maximum(scaled, 1), 0)
    diff = target - jnp.sum(s, axis=-1)

    iota = jax.lax.broadcasted_iota(jnp.int32, s.shape, s.ndim - 1)

    # diff > 0: add everything to the (first) largest entry
    jmax = jnp.argmax(s, axis=-1).astype(jnp.int32)
    add = jnp.maximum(diff, 0)
    s = s + jnp.where(iota == jmax[..., None], add[..., None], 0)
    diff = jnp.minimum(diff, 0)

    # diff < 0: repeatedly drain the (first) largest entry down to 1
    def cond(state):
        s, diff = state
        return jnp.any(diff < 0)

    def body(state):
        s, diff = state
        j = jnp.argmax(s, axis=-1).astype(jnp.int32)
        sj = jnp.max(s, axis=-1)
        take = jnp.clip(jnp.minimum(-diff, sj - 1), 0, None)
        s = s - jnp.where(iota == j[..., None], take[..., None], 0)
        return s, diff + take

    s, _ = jax.lax.while_loop(cond, body, (s, diff))

    cdf = jnp.concatenate(
        [jnp.zeros_like(s[..., :1]), jnp.cumsum(s[..., :-1], axis=-1)], axis=-1
    )
    return bits, s.astype(jnp.int32), cdf.astype(jnp.int32), off_mask
