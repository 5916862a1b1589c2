"""Sweep rANS lane count at the headline config (B=64, 256x256 gray):
per-batch encode/decode wall clock + bytes per image. Where the
per-step cost of the rANS scans is a fixed overhead (see ops/rans_jax.py
SCAN_UNROLL note), fewer steps (more lanes) buys near-linear scan
speedup at the price of per-lane state bytes on the wire (~2-4 B/lane).

Usage: python benchmarks/lane_sweep.py [nl ...]  (default 512 1024 2048)
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
import numpy as np

sys.path.insert(0, ".")
from bench import make_corpus  # noqa: E402


def main():
    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec import pipeline_jax as P
    from frave_tpu.codec.container import serialize
    from frave_tpu.fractal.schedule import get_lane_steps
    from frave_tpu.fractal.geometry import BASE_FRAC_DEPTH

    B = 64
    corpus = make_corpus(B, 256, 256, 1, seed=42)
    imgs = [RasterImage.from_array(corpus[i]) for i in range(B)]

    for nl in [int(a) for a in sys.argv[1:]] or [512, 1024, 2048]:
        opts = EncoderOptions(backend="jax", num_lanes=nl)

        def once():
            t0 = time.perf_counter()
            prog, dev, qm, meta = P._encode_dispatch(imgs, opts)
            jax.block_until_ready(dev)
            t1 = time.perf_counter()
            cis = P._encode_finish(prog, dev, qm, meta, opts)
            t2 = time.perf_counter()
            pix, m2, C = P.decode_pipeline_jax_batch(cis, _defer=True)
            jax.block_until_ready(pix)
            t3 = time.perf_counter()
            outs = P._decode_finish(pix, m2, C)
            t4 = time.perf_counter()
            return cis, outs, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)

        cis, outs, _ = once()  # compile + correctness
        for i in range(B):
            np.testing.assert_array_equal(outs[i].data, corpus[i])
        bytes_img = float(np.mean([len(serialize(ci)) for ci in cis]))

        ts = []
        for _ in range(3):
            _, _, t = once()
            ts.append(t)
        med = np.median(np.asarray(ts), axis=0) * 1e3
        steps = get_lane_steps(256, 256, nl, BASE_FRAC_DEPTH, mode=opts.mode)
        total = float(np.sum(med))
        print(
            json.dumps(
                {
                    "nl": nl,
                    "steps": int(steps.num_steps),
                    "enc_ms": round(float(med[0]), 1),
                    "enc_fetch_ms": round(float(med[1]), 1),
                    "dec_ms": round(float(med[2]), 1),
                    "dec_fetch_ms": round(float(med[3]), 1),
                    "total_ms": round(total, 1),
                    "MP/s": round(B * 65536 / 1e6 / (total / 1e3), 2),
                    "bytes/img": round(bytes_img, 1),
                }
            ),
            flush=True,
        )


if __name__ == "__main__":
    main()
