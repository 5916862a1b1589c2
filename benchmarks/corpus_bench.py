"""Config-4 benchmark: a large batch of MIXED-SIZE images on one host
(BASELINE.json config 4; scaled-down default because every image shape
compiles its own programs).

Images are bucketed by shape (jit programs are per-shape), each bucket
runs through the pipelined stream APIs (device compute overlaps host mux),
and the whole corpus is decoded and verified lossless. Prints one JSON
line with corpus MP/s.

    python benchmarks/corpus_bench.py [--n 256] [--batch 32] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

SHAPES = ((128, 128), (192, 160), (96, 224), (256, 256))


def make_mixed_corpus(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = SHAPES[i % len(SHAPES)]
        yy, xx = np.mgrid[0:h, 0:w]
        fx, fy = rng.uniform(8, 40, size=2)
        img = np.clip(
            127
            + 70 * np.sin(xx / fx + rng.uniform(0, 6.28))
            + 50 * np.cos(yy / fy)
            + rng.normal(0, 5, (h, w)),
            0,
            255,
        ).astype(np.uint8)[..., None]
        out.append(img)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument(
        "--device-verify",
        action="store_true",
        help="verify losslessness ON DEVICE (one scalar per batch, no "
        "decoded-pixel downlink — the round-trip transcode-and-verify "
        "service shape, VERDICT r4 #4)",
    )
    args = ap.parse_args()

    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec.container import deserialize, serialize
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax_stream,
        encode_pipeline_jax_stream,
        roundtrip_pipeline_jax_stream,
    )

    corpus = make_mixed_corpus(args.n, args.seed)
    opts = EncoderOptions(backend="jax")

    # shape buckets (order-preserving within bucket)
    buckets = {}
    for i, img in enumerate(corpus):
        buckets.setdefault(img.shape, []).append(i)

    def run_once():
        if args.device_verify:
            blobs = [None] * len(corpus)
            mism = 0
            for shape, idxs in buckets.items():
                imgs = [RasterImage.from_array(corpus[i]) for i in idxs]
                bl, m = roundtrip_pipeline_jax_stream(
                    imgs, opts, batch_size=args.batch, device_verify=True
                )
                for i, b in zip(idxs, bl):
                    blobs[i] = b
                mism += m
            assert mism == 0, f"{mism} mismatched pixels"
            return blobs, None
        blobs = [None] * len(corpus)
        for shape, idxs in buckets.items():
            imgs = [RasterImage.from_array(corpus[i]) for i in idxs]
            cis = encode_pipeline_jax_stream(imgs, opts, batch_size=args.batch)
            for i, ci in zip(idxs, cis):
                blobs[i] = serialize(ci)
        outs = [None] * len(corpus)
        for shape, idxs in buckets.items():
            des = [deserialize(blobs[i]) for i in idxs]
            res = decode_pipeline_jax_stream(des, batch_size=args.batch)
            for i, im in zip(idxs, res):
                outs[i] = im
        return blobs, outs

    mp = sum(im.shape[0] * im.shape[1] for im in corpus) / 1e6
    print(f"corpus: {args.n} images, {len(buckets)} shape buckets, {mp:.1f} MP",
          flush=True)
    t0 = time.perf_counter()
    blobs, outs = run_once()  # warmup/compile
    print(f"warmup (compile) {time.perf_counter() - t0:.1f}s", flush=True)
    if outs is not None:
        for i in range(len(corpus)):
            np.testing.assert_array_equal(outs[i].data, corpus[i])
    best = 0.0
    for _ in range(args.reps):
        t0 = time.perf_counter()
        blobs, outs = run_once()
        best = max(best, mp / (time.perf_counter() - t0))
    if outs is not None:
        for i in range(0, len(corpus), 37):
            np.testing.assert_array_equal(outs[i].data, corpus[i])
    total_bytes = sum(len(b) for b in blobs)
    print(
        json.dumps(
            {
                "metric": f"mixed-corpus encode+decode, {args.n} images, "
                f"{len(buckets)} shape buckets"
                + (" [device-verified]" if args.device_verify else ""),
                "value": round(best, 3),
                "unit": "MP/s",
                "bpp": round(8 * total_bytes / (mp * 1e6), 3),
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
