"""Exact equality: device table finalization vs host (the wire contract)."""

import numpy as np

from frave_tpu.entropy.tables import (
    ALPHABET_SIZE,
    CONTEXT_AMOUNT,
    _GRID_LOG2,
    _LAPLACE_GRID_ROWS,
    _LAPLACE_ROWS,
    context_from_histogram,
)


def _host_tables(hist, adaptive=False):
    """hist [CA, 1024] -> stacked (bits, freqs, cdf, off_mask, scales)."""
    bits = np.zeros(CONTEXT_AMOUNT, np.int32)
    freqs = np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), np.int64)
    cdf = np.zeros_like(freqs)
    off = np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), bool)
    scales = np.zeros(CONTEXT_AMOUNT, np.int32)
    for b in range(CONTEXT_AMOUNT):
        t = context_from_histogram(
            hist[b].astype(np.uint32), b, adaptive_scale=adaptive
        )
        bits[b] = t.max_freq_bits
        freqs[b] = t.freqs
        cdf[b] = t.cdf
        off[b, t.off_distribution_values.astype(np.int64)] = True
        scales[b] = t.scale_idx
    return bits, freqs, cdf, off, scales


def _device_tables(hist, scales=None):
    import jax.numpy as jnp

    from frave_tpu.entropy.tables_jax import finalize_contexts_device

    if scales is None:
        bits, freqs, cdf, off = finalize_contexts_device(
            jnp.asarray(hist.astype(np.int32)), jnp.asarray(_LAPLACE_ROWS)
        )
    else:
        bits, freqs, cdf, off = finalize_contexts_device(
            jnp.asarray(hist.astype(np.int32)),
            jnp.asarray(_LAPLACE_GRID_ROWS),
            scale_idx=jnp.asarray(scales),
        )
    return (
        np.asarray(bits),
        np.asarray(freqs).astype(np.int64),
        np.asarray(cdf).astype(np.int64),
        np.asarray(off),
    )


def _check(hist):
    # legacy path: per-bucket rows, no scale index
    hb, hf, hc, ho, _ = _host_tables(hist)
    db, df, dc, do = _device_tables(hist)
    np.testing.assert_array_equal(hb, db)
    np.testing.assert_array_equal(hf, df)
    np.testing.assert_array_equal(hc, dc)
    np.testing.assert_array_equal(ho, do)
    # v9 path: the HOST-selected scales drive BOTH sides (the wire
    # contract — given the same scale indices the finalized tables must
    # be bit-identical; the selection itself is encode-only and may
    # differ across backends)
    hb, hf, hc, ho, hs = _host_tables(hist, adaptive=True)
    db, df, dc, do = _device_tables(hist, scales=hs)
    np.testing.assert_array_equal(hb, db)
    np.testing.assert_array_equal(hf, df)
    np.testing.assert_array_equal(hc, dc)
    np.testing.assert_array_equal(ho, do)


def test_scale_selection_agrees_on_cpu():
    """Host select_scale vs device select_scales_device: both are f32
    dot products, so on the CPU backend they must agree exactly. (On an
    accelerator the contraction may order sums differently — that is
    fine, the chosen index travels on the wire.)"""
    import jax.numpy as jnp

    from frave_tpu.entropy.tables import select_scale
    from frave_tpu.entropy.tables_jax import select_scales_device

    rng = np.random.default_rng(5)
    j = np.arange(ALPHABET_SIZE)
    hist = np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), np.int64)
    for b in range(CONTEXT_AMOUNT):
        lam = 0.7 + 2.9 * b
        p = np.exp(-((j + 1) // 2) / lam)
        hist[b] = rng.poisson(4000 * p / p.sum())
    host = []
    for b in range(CONTEXT_AMOUNT):
        total = int(hist[b].sum())
        bits = max(8, min(int(total).bit_length() - 1, 12))
        host.append(select_scale(hist[b], bits))
    dev = select_scales_device(
        jnp.asarray(hist.astype(np.int32)),
        jnp.asarray(_GRID_LOG2),
        jnp.asarray((_LAPLACE_GRID_ROWS == 0).astype(np.float32)),
    )
    np.testing.assert_array_equal(np.asarray(host), np.asarray(dev))


def test_empty_histograms():
    _check(np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), np.int64))


def test_laplace_like_histograms():
    rng = np.random.default_rng(0)
    j = np.arange(ALPHABET_SIZE)
    hist = np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), np.int64)
    for b in range(CONTEXT_AMOUNT):
        lam = 2.0 + 4.0 * b
        p = np.exp(-((j + 1) // 2) / lam)
        hist[b] = rng.poisson(2000 * p / p.sum())
    _check(hist)


def test_uniform_noise_histograms():
    """Wide spreads force the bits-bump path (nnz > 1 << bits0)."""
    rng = np.random.default_rng(1)
    hist = rng.integers(0, 3, size=(CONTEXT_AMOUNT, ALPHABET_SIZE)).astype(np.int64)
    _check(hist)


def test_sparse_and_spiky():
    rng = np.random.default_rng(2)
    hist = np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), np.int64)
    for b in range(CONTEXT_AMOUNT):
        idx = rng.choice(ALPHABET_SIZE, size=5, replace=False)
        hist[b, idx] = rng.integers(1, 100000, size=5)
    _check(hist)


def test_single_symbol():
    hist = np.zeros((CONTEXT_AMOUNT, ALPHABET_SIZE), np.int64)
    hist[:, 700] = 12345  # a far-tail symbol where laplace rounds to 0
    _check(hist)


def test_batched_shapes():
    """The device twin must handle leading batch dims."""
    import jax.numpy as jnp

    from frave_tpu.entropy.tables_jax import finalize_contexts_device

    rng = np.random.default_rng(3)
    hist = rng.integers(0, 50, size=(2, 3, CONTEXT_AMOUNT, ALPHABET_SIZE)).astype(
        np.int32
    )
    bits, freqs, cdf, off = finalize_contexts_device(
        jnp.asarray(hist), jnp.asarray(_LAPLACE_ROWS)
    )
    assert bits.shape == (2, 3, CONTEXT_AMOUNT)
    for i in range(2):
        for jj in range(3):
            hb, hf, hc, ho, _ = _host_tables(hist[i, jj].astype(np.int64))
            np.testing.assert_array_equal(hb, np.asarray(bits[i, jj]))
            np.testing.assert_array_equal(hf, np.asarray(freqs[i, jj]).astype(np.int64))
