"""Ablate the fused encode: time progressively larger stage prefixes.

Rebuilds encode_fused's stages outside the class so each prefix can be
jitted and timed separately on the live backend. Defaults to the
headline config (B=64, 256x256 gray); override with env vars ABL_B,
ABL_H, ABL_W, ABL_C (e.g. ABL_B=1 ABL_H=2048 ABL_W=2048 ABL_C=3).
Positional args select stages by prefix (e.g. `5 6 7`).
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, ".")
from bench import make_corpus  # noqa: E402


def timeit(fn, *args, reps=4):
    out = fn(*args)
    jax.block_until_ready(out)
    # one device->host fetch before timing: a first fetch can carry
    # one-off set-up cost
    np.asarray(jnp.zeros(()))
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best


def main():
    from frave_tpu.codec import pipeline_jax as P
    from frave_tpu.codec.options import EncoderOptions, quantization_matrix
    from frave_tpu.fractal.geometry import BASE_FRAC_DEPTH
    from frave_tpu.fractal.schedule import default_num_lanes, get_schedule
    from frave_tpu.ops import jax_ops as J
    from frave_tpu.ops.rans_jax import encode_scan, stream_compact
    from frave_tpu.entropy.tables_jax import finalize_contexts_device
    from frave_tpu.entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT

    B = int(os.environ.get("ABL_B", "64"))
    h = int(os.environ.get("ABL_H", "256"))
    w = int(os.environ.get("ABL_W", "256"))
    C = int(os.environ.get("ABL_C", "1"))
    corpus = make_corpus(B, h, w, C, seed=42)
    sched = get_schedule(h, w, mode="parallel")
    nl = default_num_lanes(sched.num_symbols)
    prog = P.get_program(h, w, BASE_FRAC_DEPTH, nl, C, "parallel")
    depth = BASE_FRAC_DEPTH
    K = prog.num_symbols
    R = prog.rows
    n_slots = prog.n_slots

    (leaf_safe, leaf_mask, sc, snbr_safe, slf, sgrp, sfbkt, lap, glog2,
     gzero) = prog._enc_args
    perm = prog._inv_perm  # decode-rank sort key (stream_compact)
    group_ranges = prog._group_ranges

    qm = quantization_matrix(EncoderOptions().quality)
    qdiv = jnp.asarray(P._qdiv_array(qm, depth))
    pixels = jnp.asarray(
        np.stack([corpus[i].reshape(-1, C).T.astype(np.int32) for i in range(B)])
    )

    _HI = jax.lax.Precision.HIGHEST

    def stage_lift(pixels, qdiv):
        leaves = jnp.where(leaf_mask[None], pixels[:, leaf_safe], 0).astype(jnp.int32)
        coef = J.forward_lifting(leaves, leaf_mask[None], depth)
        qcoef = J.quantize(coef, qdiv[None, None, :])
        qpad = jnp.concatenate(
            [qcoef.reshape(C, n_slots).astype(jnp.int16), jnp.zeros((C, 1), jnp.int16)],
            axis=1,
        )
        return qpad

    def stage_gather(pixels, qdiv):
        qpad = stage_lift(pixels, qdiv)
        vals = qpad[:, snbr_safe].astype(jnp.int32)
        target = qpad[:, sc].astype(jnp.int32)
        return vals, target

    def feats(Xs):
        return jnp.stack(
            [
                jnp.ones(Xs.shape[:-1], Xs.dtype),
                jnp.abs(Xs[..., 0] - Xs[..., 3]),
                jnp.abs(Xs[..., 1] - Xs[..., 2]),
                jnp.abs(Xs[..., 4] - Xs[..., 5]),
                jnp.abs(Xs[..., 1] - Xs[..., 5]),
                jnp.abs(Xs[..., 2] - Xs[..., 4]),
            ],
            axis=-1,
        )

    def stage_fits(pixels, qdiv):
        vals, target = stage_gather(pixels, qdiv)
        Gs, bs = [], []
        for (lo, hi) in group_ranges:
            Xs = vals[:, lo:hi].astype(jnp.float32)
            ys = target[:, lo:hi].astype(jnp.float32)
            Gs.append(jnp.einsum("ckx,cky->cxy", Xs, Xs, precision=_HI))
            bs.append(jnp.einsum("ckx,ck->cx", Xs, ys, precision=_HI))
        G = jnp.stack(Gs, axis=1)
        bv = jnp.stack(bs, axis=1)
        vparams = P._gram_solve(G, bv)
        vparams = jax.lax.optimization_barrier(J.f16_wire_round(vparams))
        Gws, bws = [], []
        for g, (lo, hi) in enumerate(group_ranges):
            Xs = vals[:, lo:hi].astype(jnp.float32)
            ys = target[:, lo:hi].astype(jnp.float32)
            pred_g = jnp.einsum("ckx,cx->ck", Xs, vparams[:, g], precision=_HI)
            rg = jnp.abs(ys - pred_g)
            Fs = feats(Xs)
            Gws.append(jnp.einsum("ckx,cky->cxy", Fs, Fs, precision=_HI))
            bws.append(jnp.einsum("ckx,ck->cx", Fs, rg, precision=_HI))
        wparams = P._gram_solve(jnp.stack(Gws, axis=1), jnp.stack(bws, axis=1))
        wparams = jax.lax.optimization_barrier(J.f16_wire_round(wparams))
        return vals, target, vparams, wparams

    def stage_ctx(pixels, qdiv):
        vals, target, vparams, wparams = stage_fits(pixels, qdiv)
        buckets, preds = jax.vmap(
            lambda v, vp, wp: J.contexts(v, slf, sgrp, vp, wp)
        )(vals, vparams, wparams)
        buckets = jnp.where(sfbkt[None] >= 0, sfbkt[None], buckets)
        symbols = J.pack_signed(target - preds)
        return buckets, symbols

    def stage_hist(pixels, qdiv):
        buckets, symbols = stage_ctx(pixels, qdiv)
        ids = (
            jnp.arange(C, dtype=jnp.int32)[:, None] * (CONTEXT_AMOUNT * ALPHABET_SIZE)
            + buckets * ALPHABET_SIZE
            + jnp.clip(symbols, 0, ALPHABET_SIZE - 1)
        )
        hist = (
            jnp.zeros(C * CONTEXT_AMOUNT * ALPHABET_SIZE, jnp.int32)
            .at[ids.reshape(-1)]
            .add(1)
            .reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
        )
        from frave_tpu.entropy.tables_jax import select_scales_device

        scales = select_scales_device(hist, glog2, gzero)
        bits, freqs, cdfs, off_mask = finalize_contexts_device(
            hist, lap, scale_idx=scales
        )
        return buckets, symbols, bits, freqs, cdfs

    def stage_scan(pixels, qdiv):
        buckets, symbols, bits, freqs, cdfs = stage_hist(pixels, qdiv)
        pad = R * nl - K

        def grid(a, fill):
            a = jnp.concatenate([a, jnp.full((C, pad), fill, dtype=a.dtype)], axis=1)
            return a.reshape(C, R, nl).transpose(1, 0, 2)

        sym_g = grid(symbols, 0)
        bkt_g = grid(buckets, 0)
        val_g = grid(jnp.ones((C, K), dtype=jnp.bool_), False)
        states, words, flags = encode_scan(
            sym_g, bkt_g, val_g, freqs.astype(jnp.uint32), cdfs.astype(jnp.uint32), bits
        )
        return states, words, flags

    def stage_full(pixels, qdiv):
        states, words, flags = stage_scan(pixels, qdiv)
        stream, total = stream_compact(words, flags, perm, kc=prog.kc)
        return states, stream, total

    stages = [
        ("1_lift_quant", stage_lift),
        ("2_nbr_gather", stage_gather),
        ("3_fits", stage_fits),
        ("4_contexts", stage_ctx),
        ("5_hist_tables", stage_hist),
        ("6_rans_scan", stage_scan),
        ("7_compact", stage_full),
    ]
    want = sys.argv[1:] or [n for n, _ in stages]
    results = {}
    for name, fn in stages:
        if not any(name.startswith(p) for p in want):
            continue
        jfn = jax.jit(jax.vmap(fn, in_axes=(0, None)))
        results[name] = round(timeit(jfn, pixels, qdiv), 1)
        print(name, results[name], flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
