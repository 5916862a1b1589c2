"""Measure the single-thread C reference baseline (csrc/refbase.cpp) at
every BASELINE.json config shape, with encode/decode split, both
faithful (per-image lattice rebuild, what the reference CLI does —
wavelet_transform.rs:405,392) and geometry-cached variants.

Prints one line per (shape, variant): enc MP/s, dec MP/s, rt MP/s.
Pure CPU — needs no accelerator."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks.big_probe import make_image  # noqa: E402


def measure(h, w, c, reps=3, faithful_reps=None):
    from frave_tpu.native import refbase_roundtrip

    img = make_image(h, w, c, seed=1)
    mp = h * w / 1e6
    out = {}
    for cache, name in ((False, "faithful"), (True, "cached")):
        r = reps if (cache or faithful_reps is None) else faithful_reps
        te_b = td_b = 1e18
        for _ in range(r):
            te, td, nbytes = refbase_roundtrip(img, cache_geometry=cache)
            te_b, td_b = min(te_b, te), min(td_b, td)
        out[name] = (mp / te_b, mp / td_b, mp / (te_b + td_b), nbytes)
        print(
            f"{h}x{w}x{c} {name}: enc {mp/te_b:.3f} MP/s  dec {mp/td_b:.3f}"
            f" MP/s  rt {mp/(te_b+td_b):.3f} MP/s  bytes {nbytes}",
            flush=True,
        )
    return out


def main():
    shapes = os.environ.get(
        "RB_SHAPES",
        "256,256,1;512,512,1;1024,1024,3;2048,2048,3",
    )
    for spec in shapes.split(";"):
        h, w, c = (int(x) for x in spec.split(","))
        reps = 3 if h <= 1024 else 2
        measure(h, w, c, reps=reps)

    # mixed-size corpus (config 4 shape mix): report aggregate MP/s
    if os.environ.get("RB_MIXED", "1") == "1":
        from frave_tpu.native import refbase_roundtrip

        sizes = [(128, 128), (256, 256), (384, 256), (512, 512)]
        imgs = [
            make_image(h, w, 1, seed=i)
            for i, (h, w) in enumerate(sizes * 4)
        ]
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        for cache, name in ((False, "faithful"), (True, "cached")):
            t0 = time.perf_counter()
            for im in imgs:
                refbase_roundtrip(im, cache_geometry=cache)
            dt = time.perf_counter() - t0
            print(
                f"mixed({len(imgs)} imgs, {mp:.2f} MP) {name}: "
                f"rt {mp/dt:.3f} MP/s",
                flush=True,
            )


if __name__ == "__main__":
    main()
