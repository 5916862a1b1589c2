"""Config-3 benchmark: one large RGB image on a single chip
(BASELINE.json config 3 measures the 2048x2048 tile-sharded case; this
is its single-chip counterpart — steady-state round-trip MP/s at
1024x1024 and 2048x2048 RGB).

    python benchmarks/large_image.py [--sizes 1024 2048] [--reps 3]
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


def make_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        127
        + 70 * np.sin(xx / 37.0)
        + 50 * np.cos(yy / 23.0)
        + rng.normal(0, 5, (h, w))
    )
    out = np.stack(
        [np.clip(base + 10 * c, 0, 255) for c in range(3)], axis=-1
    ).astype(np.uint8)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="*", default=[1024, 2048])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--lanes", type=int, default=None)
    ap.add_argument("--mode", default="parallel")
    args = ap.parse_args()

    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec.container import deserialize, serialize
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax_batch,
        encode_pipeline_jax_batch,
    )

    opts = EncoderOptions(
        backend="jax", num_lanes=args.lanes, mode=args.mode
    )
    for s in args.sizes:
        img = make_image(s, s)
        ri = RasterImage.from_array(img)

        def once():
            t0 = time.perf_counter()
            cis = encode_pipeline_jax_batch([ri], opts)
            t1 = time.perf_counter()
            blob = serialize(cis[0])
            out = decode_pipeline_jax_batch([deserialize(blob)])[0]
            t2 = time.perf_counter()
            return blob, out, t1 - t0, t2 - t1

        blob, out, te, td = once()  # compile + verify
        np.testing.assert_array_equal(out.data, img)
        enc_s = dec_s = 1e9
        for _ in range(args.reps):
            _, out, te, td = once()
            enc_s = min(enc_s, te)
            dec_s = min(dec_s, td)
        np.testing.assert_array_equal(out.data, img)
        mp = s * s / 1e6
        print(
            json.dumps(
                {
                    "size": f"{s}x{s}x3",
                    "enc_s": round(enc_s, 2),
                    "dec_s": round(dec_s, 2),
                    "MP/s": round(mp / (enc_s + dec_s), 3),
                    "bytes": len(blob),
                    "bpp/ch": round(8 * len(blob) / (3 * s * s), 2),
                }
            ),
            flush=True,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
