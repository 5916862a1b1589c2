"""Round-3 probe: 2048x2048 RGB encode/decode wall+device split across
decode variants (merged in-scan gather / compare-free in-scan /
segment-bulk). Honest timing: fetch a scalar before each timer read."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def sync():
    import jax
    import jax.numpy as jnp

    np.asarray(jnp.zeros(()))


def make_image(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = (
        127.0
        + 70.0 * np.sin(xx / 31.0)
        + 50.0 * np.cos(yy / 17.0)
        + rng.normal(0, 5.0, size=(h, w))
    )
    out = np.zeros((h, w, c), dtype=np.uint8)
    for ch in range(c):
        out[:, :, ch] = np.clip(base + 10 * ch, 0, 255).astype(np.uint8)
    return out


def main():
    h = int(os.environ.get("PROBE_H", "2048"))
    w = int(os.environ.get("PROBE_W", "2048"))
    c = int(os.environ.get("PROBE_C", "3"))
    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec.pipeline_jax import (
        _encode_dispatch,
        _encode_finish,
        decode_pipeline_jax_batch,
        get_program,
    )
    from frave_tpu.images import ColorSpace, ImageMetadata

    meta = ImageMetadata(
        height=h, width=w,
        colorspace=ColorSpace.RGB if c == 3 else ColorSpace.Luma,
    )
    img = RasterImage(metadata=meta, data=make_image(h, w, c))
    opts = EncoderOptions()

    t0 = time.perf_counter()
    prog, dev, qm, m2 = _encode_dispatch([img], opts)
    sync()
    print(f"geometry+sched+compile+enc dispatch: {time.perf_counter()-t0:.2f}s", flush=True)
    print(f"num_symbols={prog.num_symbols} nl={prog.nl} steps={prog.num_steps} "
          f"rows={prog.rows} segments={len(prog._segments)}", flush=True)

    cis = _encode_finish(prog, dev, qm, m2, opts)

    # warm encode timing
    for rep in range(3):
        t0 = time.perf_counter()
        prog, dev, qm, m2 = _encode_dispatch([img], opts)
        cis = _encode_finish(prog, dev, qm, m2, opts)
        t1 = time.perf_counter()
        print(f"encode warm rep{rep}: {t1-t0:.3f}s", flush=True)

    # decode timing
    t0 = time.perf_counter()
    out = decode_pipeline_jax_batch(cis)
    print(f"decode cold: {time.perf_counter()-t0:.2f}s", flush=True)
    for rep in range(3):
        t0 = time.perf_counter()
        out = decode_pipeline_jax_batch(cis)
        t1 = time.perf_counter()
        print(f"decode warm rep{rep}: {t1-t0:.3f}s", flush=True)
    ok = np.array_equal(out[0].data, img.data)
    mp = h * w / 1e6
    print(f"lossless={ok}  encode is above; MP={mp:.2f}", flush=True)


if __name__ == "__main__":
    main()
