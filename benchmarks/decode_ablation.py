"""Knock-out ablation of the decode wavefront scan (headline config:
B=64, 256x256 gray). Each variant removes one part of the per-step body
(timing only — knocked-out variants decode garbage) so the per-step
cost can be attributed:

  full        the production body
  no_ctx      contexts + neighbour gather replaced by constants
  no_merged   merged-table gather replaced by constants
  no_stream   renorm word read (dynamic_slice + distribution) removed
  no_scatter  qpad coefficient scatter removed

Run: python benchmarks/decode_ablation.py [variant ...]

CAVEAT (round 2 finding): knockouts that stop writing or reading the
coefficient-plane carry (no_scatter, no_ctx) also break the scan's
loop-carried dependency, so XLA can overlap steps that production must
serialize. Their deltas measure the cost of the dependency chain, NOT
the knocked-out op alone: an int32+unique_indices scatter rewrite that
the isolated microbenchmark said was 25x faster changed end-to-end
decode by ~0 on the hardware first measured (slightly WORSE). The
wavefront scan there was bound by the
per-step critical path gather->contexts->rANS->scatter, not by any op's
throughput in isolation.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, ".")
from bench import make_corpus  # noqa: E402


def main():
    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec import pipeline_jax as P
    from frave_tpu.codec.pipeline_jax import assemble_wire_batch, pick_lut_bits
    from frave_tpu.entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT
    from frave_tpu.entropy.tables_jax import finalize_contexts_device
    from frave_tpu.ops import jax_ops as J
    from frave_tpu.ops.rans_jax import (
        LUT_BITS,
        RANS_L,
        WORD_BITS,
        build_merged_decode_table,
    )

    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=[])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--channels", type=int, default=1)
    ap.add_argument("--lanes", type=int, default=None)
    ns = ap.parse_args()
    B = ns.batch
    corpus = make_corpus(B, ns.size, ns.size, ns.channels, seed=42)
    imgs = [RasterImage.from_array(corpus[i]) for i in range(B)]
    opts = EncoderOptions(backend="jax", num_lanes=ns.lanes)
    prog, dev, qm, meta = P._encode_dispatch(imgs, opts)
    cis = P._encode_finish(prog, dev, qm, meta, opts)

    nl = prog.nl
    C = prog.channels
    n_slots = prog.n_slots
    (states, streams, bits_w, offpk, scw, vp, wp, qdiv,
     _tids) = assemble_wire_batch(cis, nl)
    lut_bits = pick_lut_bits(bits_w)
    (d_coef, d_active, d_nbr, d_lf, d_grp, d_fbkt, pix_inv, node_mask,
     leaf_inb) = prog._dec_args
    lap = prog._lap

    def body_factory(skip):
        def decode_one(states_i, stream_i, bits_i, offpk_i, sc_i, vp_i, wp_i):
            shifts32 = jnp.arange(32, dtype=jnp.uint32)
            off_mask = (
                ((offpk_i[..., None] >> shifts32) & jnp.uint32(1)) > 0
            ).reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
            zero_hist = jnp.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), jnp.int32)
            tb, freqs_i, cdfs_i, _ = finalize_contexts_device(
                zero_hist, lap, bits0=bits_i, off_mask_in=off_mask,
                scale_idx=sc_i,
            )
            merged = build_merged_decode_table(freqs_i, cdfs_i, tb, lut_bits)
            qpad0 = jnp.zeros((C, n_slots + 1), dtype=jnp.int16)

            def body(carry, xs):
                qpad, x, gptr = carry
                coef_safe, active, nbr_safe, lf, grp, fbkt = xs
                if "ctx" in skip:
                    buckets = jnp.full((C, nl), 5, jnp.int32)
                    preds = jnp.zeros((C, nl), jnp.int32)
                else:
                    vals = qpad[:, nbr_safe].astype(jnp.int32)
                    buckets, preds = jax.vmap(
                        lambda v, vpp, wpp: J.contexts(
                            v, lf, grp, vpp, wpp, onehot_params=True
                        )
                    )(vals, vp_i, wp_i)
                    buckets = jnp.where(fbkt[None] >= 0, fbkt[None], buckets)
                act = jnp.broadcast_to(active[None], (C, nl))
                bkt = jnp.clip(buckets, 0, CONTEXT_AMOUNT - 1).astype(jnp.int32)
                oh = (
                    bkt[..., None] == jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)
                ).astype(jnp.float32)
                bi = jnp.einsum("cnk,ck->cn", oh, tb.astype(jnp.float32)).astype(
                    jnp.uint32
                )
                mask = (jnp.uint32(1) << bi) - jnp.uint32(1)
                slot = x & mask
                if "merged" in skip:
                    fr = jnp.full((C, nl), 256, jnp.uint32)
                    cd = jnp.zeros((C, nl), jnp.uint32)
                    sym = jnp.full((C, nl), 100, jnp.int32)
                else:
                    fine = (slot << (jnp.uint32(lut_bits) - bi)).astype(jnp.int32)
                    g2 = jax.vmap(lambda t, bk, f: t[bk, f])(merged, bkt, fine)
                    fr = g2[..., 0] >> jnp.uint32(16)
                    cd = g2[..., 0] & jnp.uint32(0xFFFF)
                    sym = g2[..., 1].astype(jnp.int32)
                x_new = fr * (x >> bi) + slot - cd
                need = act & (x_new < jnp.uint32(RANS_L))
                nf = need.reshape(-1).astype(jnp.int32)
                pos = jnp.cumsum(nf) - 1
                if "stream" in skip:
                    w = jnp.zeros((C, nl), jnp.uint32)
                else:
                    # mirror production decode_step_merged: one-hot
                    # contraction for small word blocks, linear
                    # batched-index gather for wide ones
                    blk = C * nl
                    block = jax.lax.dynamic_slice(stream_i, (gptr,), (blk,))
                    if blk <= 2048:
                        block_bytes = jnp.stack(
                            [block & jnp.uint16(0xFF), block >> jnp.uint16(8)],
                            axis=-1,
                        ).astype(jnp.float32)
                        ohp = (
                            (pos[:, None] == jnp.arange(blk, dtype=jnp.int32))
                            & (nf[:, None] > 0)
                        ).astype(jnp.float32)
                        wb = jnp.einsum("nb,bk->nk", ohp, block_bytes).astype(
                            jnp.uint32
                        )
                        w = (
                            wb[..., 0] | (wb[..., 1] << jnp.uint32(8))
                        ).reshape(C, nl)
                    else:
                        w = block[jnp.clip(pos, 0, blk - 1)].reshape(
                            C, nl
                        ).astype(jnp.uint32)
                x_new = jnp.where(need, (x_new << jnp.uint32(WORD_BITS)) | w, x_new)
                x = jnp.where(act, x_new, x)
                gptr = gptr + jnp.sum(nf)
                if "scatter" not in skip:
                    values = J.unpack_signed(sym) + preds
                    wslot = jnp.where(act, coef_safe[None], n_slots)
                    wval = jnp.where(act, values, 0).astype(jnp.int16)
                    qpad = jax.vmap(lambda q, s, v: q.at[s].set(v))(
                        qpad, wslot, wval
                    )
                return (qpad, x, gptr), None

            (qpad, x, gptr), _ = jax.lax.scan(
                body,
                (qpad0, states_i, jnp.int32(0)),
                (d_coef, d_active, d_nbr, d_lf, d_grp, d_fbkt),
            )
            return qpad[:, :64].astype(jnp.int32).sum() + x.sum(
                dtype=jnp.uint32
            ).astype(jnp.int32)

        return jax.jit(jax.vmap(decode_one))

    args = (
        jnp.asarray(states),
        jnp.asarray(streams),
        jnp.asarray(bits_w),
        jnp.asarray(offpk),
        jnp.asarray(scw),
        jnp.asarray(vp),
        jnp.asarray(wp),
    )
    variants = ["full", "no_ctx", "no_merged", "no_stream", "no_scatter"]
    want = ns.variants or variants
    results = {}
    for v in variants:
        if v not in want:
            continue
        skip = () if v == "full" else (v[3:],)
        fn = body_factory(skip)
        out = fn(*args)
        jax.block_until_ready(out)
        best = 1e9
        for _ in range(4):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        results[v] = round(1e3 * best, 1)
        print(v, results[v], flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
