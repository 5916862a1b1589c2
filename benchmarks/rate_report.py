"""Lossless rate report on a REAL-image corpus vs PNG.

The corpus is real photographs shipped inside installed packages
(skipped gracefully if absent) plus the reference repo's own test
image. Run:

    python benchmarks/rate_report.py [--backend numpy|jax] [--trial]

Prints a per-image table (frif bpp vs PNG bpp) and corpus averages.
"""

from __future__ import annotations

import argparse
import io
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

CORPUS = {
    # Grace Hopper portrait (public-domain US Navy photo, ships with
    # matplotlib sample data) — classic natural test image
    "hopper": "/opt/venv/lib/python3.12/site-packages/matplotlib/"
    "mpl-data/sample_data/grace_hopper.jpg",
    # real webcam photo from pygame docs
    "camera": "/opt/venv/lib/python3.12/site-packages/pygame/docs/"
    "generated/_images/camera_average.jpg",
    "freedom": "/opt/venv/lib/python3.12/site-packages/pygame/docs/"
    "generated/_images/intro_freedom.jpg",
    "blade": "/opt/venv/lib/python3.12/site-packages/pygame/docs/"
    "generated/_images/intro_blade.jpg",
    # the reference repo's own test image
    "fractals": "/root/reference/img/fractals.gif",
    # screen content (document/table screenshot with anti-aliased text) —
    # a distinct content class from photos and flat graphics; cropped to a
    # text-dense region (the full 3526x1292 scan is slow on the numpy
    # oracle with --trial)
    "screendoc": (
        "/opt/venv/lib/python3.12/site-packages/aqt/jax_legacy/"
        "jax/imagenet/imagenet.png",
        (600, 150, 1600, 750),  # left, top, right, bottom
    ),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="numpy", choices=["numpy", "jax"])
    ap.add_argument(
        "--trial",
        action="store_true",
        help="exact per-image color-transform selection (encodes all candidates)",
    )
    args = ap.parse_args()

    from PIL import Image

    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec.decoder import FRIDecoder
    from frave_tpu.codec.encoder import FRIEncoder

    opts = EncoderOptions(
        backend=args.backend,
        color_transform="trial" if args.trial else "auto",
    )
    enc = FRIEncoder(opts)
    dec = FRIDecoder(backend=args.backend)

    sums = {"gray": [0.0, 0.0, 0], "rgb": [0.0, 0.0, 0]}
    for name, entry in CORPUS.items():
        path, crop = entry if isinstance(entry, tuple) else (entry, None)
        if not os.path.exists(path):
            print(f"{name:9s} SKIP (not present)")
            continue
        im = Image.open(path)
        if crop is not None:
            im = im.crop(crop)
        for mode, tag in (("L", "gray"), ("RGB", "rgb")):
            arr = np.asarray(im.convert(mode))
            if arr.ndim == 2:
                arr = arr[:, :, None]
            h, w, _ = arr.shape
            blob = enc.encode(RasterImage.from_array(arr))
            out = dec.decode(blob)
            assert np.array_equal(out.data, arr), f"{name} {tag} not lossless"
            buf = io.BytesIO()
            Image.fromarray(arr.squeeze(), mode=mode).save(
                buf, format="PNG", optimize=True
            )
            bpp_f = 8 * len(blob) / (h * w)
            bpp_p = 8 * len(buf.getvalue()) / (h * w)
            sums[tag][0] += bpp_f
            sums[tag][1] += bpp_p
            sums[tag][2] += 1
            print(
                f"{name:9s} {tag:4s} {h}x{w}: frif {bpp_f:6.3f} bpp  "
                f"png {bpp_p:6.3f} bpp  ratio {bpp_f / bpp_p:5.2f}"
            )
    for tag, (f, p, n) in sums.items():
        if n:
            print(
                f"average   {tag:4s}: frif {f / n:6.3f} bpp  png {p / n:6.3f}"
                f" bpp  ratio {f / p:5.2f}"
            )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
