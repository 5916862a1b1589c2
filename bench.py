"""Benchmark: encode+decode throughput on the primary config, on a GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "MP/s", "vs_baseline": N,
   "platform": "gpu", "device_kind": ..., "device_count": N,
   "card": "<name>, <power limit>", ...}

Config (BASELINE.json config 1, widened for throughput): a batch of
256x256 grayscale natural-statistics images, full encode -> container
bytes -> decode round trip on the JAX backend, verified lossless against
the input. Refuses to run (non-zero exit) when JAX finds no GPU: a CPU
timing is not a device number.

vs_baseline: the reference publishes no numbers, so the denominator is
the single-thread C reimplementation of the reference pipeline
(csrc/refbase.cpp, ctypes-driven), measured in the same run on the same
corpus images. Like the reference CLI it rebuilds the tile lattice per
image (wavelet_transform.rs:405,392). Falls back to the numpy host
oracle only if the native toolchain is unavailable.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np


def make_corpus(n: int, h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    """Natural-statistics synthetic images: smooth fields + texture + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((n, h, w, c), dtype=np.uint8)
    for i in range(n):
        fx, fy = rng.uniform(8, 40, size=2)
        px, py = rng.uniform(0, 6.28, size=2)
        base = (
            127.0
            + 70.0 * np.sin(xx / fx + px)
            + 50.0 * np.cos(yy / fy + py)
            + rng.normal(0, 5.0, size=(h, w))
        )
        for ch in range(c):
            out[i, :, :, ch] = np.clip(base + 10.0 * ch, 0, 255).astype(np.uint8)
    return out


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them (read
    in a child process that does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def require_gpu():
    """The JAX devices, when the first one is a GPU; exits non-zero
    otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs a GPU, but JAX found platform {devs[0].platform!r}")
    return devs


def _bench_opts():
    from frave_tpu import EncoderOptions

    nl_env = os.environ.get("FRAVE_BENCH_LANES")
    return EncoderOptions(
        backend="jax",
        num_lanes=int(nl_env) if nl_env else None,
        mode=os.environ.get("FRAVE_BENCH_MODE", "grid"),
    )


# Public photographs that installed packages ship as sample data:
# (package, path inside the package).
_REAL_SOURCES = (
    ("matplotlib", "mpl-data/sample_data/grace_hopper.jpg"),
    ("pygame", "docs/generated/_images/camera_average.jpg"),
    ("pygame", "docs/generated/_images/intro_freedom.jpg"),
    ("pygame", "docs/generated/_images/intro_blade.jpg"),
)


def _package_file(package: str, relpath: str) -> str | None:
    spec = importlib.util.find_spec(package)
    if spec is None or not spec.submodule_search_locations:
        return None
    return os.path.join(list(spec.submodule_search_locations)[0], relpath)


def load_real_corpus(n: int, h: int, w: int) -> np.ndarray | None:
    """Real-photograph corpus (VERDICT r2 #5): grayscale h x w crops of
    public photos shipped with installed packages, augmented by dihedral
    flips to reach n images. Returns None when no source image is
    present (the caller reports the corpus as not available)."""
    paths = [_package_file(pkg, rel) for pkg, rel in _REAL_SOURCES]
    try:
        from PIL import Image
    except ImportError:
        return None
    crops = []
    for p in paths:
        if p is None or not os.path.exists(p):
            continue
        im = Image.open(p).convert("L")
        if min(im.size) < max(h, w):
            s = max(h / im.size[1], w / im.size[0])
            im = im.resize(
                (int(np.ceil(im.size[0] * s)), int(np.ceil(im.size[1] * s)))
            )
        a = np.asarray(im)
        for i in range(0, a.shape[0] - h + 1, h):
            for j in range(0, a.shape[1] - w + 1, w):
                crops.append(a[i : i + h, j : j + w])
    if not crops:
        return None
    out = []
    k = 0
    while len(out) < n:
        c = crops[k % len(crops)]
        d = k // len(crops)  # dihedral variant
        if d & 1:
            c = c[::-1]
        if d & 2:
            c = c[:, ::-1]
        if d & 4:
            c = c.T
        out.append(np.ascontiguousarray(c))
        k += 1
    return np.stack(out)[..., None]


def bench_jax(
    corpus: np.ndarray,
    reps: int = 6,
    batch_size: int = 64,
    device_verify: bool = False,
) -> float:
    """Batched encode -> container bytes -> batched decode, verified.
    device_verify=True checks losslessness ON DEVICE (one scalar fetch
    per batch instead of the pixel downlink — VERDICT r4 #4); the
    classic mode fetches and compares every pixel on host."""
    from frave_tpu import RasterImage
    from frave_tpu.codec.pipeline_jax import roundtrip_pipeline_jax_stream

    opts = _bench_opts()
    n, h, w, c = corpus.shape
    imgs = [RasterImage.from_array(corpus[i]) for i in range(n)]

    def roundtrip():
        # encode -> container bytes -> decode, software-pipelined so
        # fetches/mux overlap the other stage's device compute
        return roundtrip_pipeline_jax_stream(
            imgs, opts, batch_size=batch_size, device_verify=device_verify
        )

    def check(outs):
        if device_verify:
            assert outs == 0, f"{outs} mismatched pixels"
        else:
            for i in range(n):
                np.testing.assert_array_equal(outs[i].data, corpus[i])

    blobs, outs = roundtrip()  # warmup (compile)
    check(outs)

    mp = n * h * w / 1e6
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        blobs, outs = roundtrip()
        dt = time.perf_counter() - t0
        best = max(best, mp / dt)
    check(outs)
    return best


def bench_split(corpus: np.ndarray, reps: int = 3, batch_size: int = 64):
    """Encode-only and decode-only MP/s (VERDICT r2 #2: the north star's
    literal wording is encode throughput). Returns (enc_mp_s, dec_mp_s),
    lossless-verified."""
    import time as _t

    from frave_tpu import RasterImage
    from frave_tpu.codec.container import deserialize, serialize
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax_stream,
        encode_pipeline_jax_stream,
    )

    opts = _bench_opts()
    n, h, w, _ = corpus.shape
    imgs = [RasterImage.from_array(corpus[i]) for i in range(n)]
    mp = n * h * w / 1e6

    cis = encode_pipeline_jax_stream(imgs, opts, batch_size)  # warm
    blobs = [serialize(ci) for ci in cis]
    enc = 0.0
    for _ in range(reps):
        t0 = _t.perf_counter()
        cis = encode_pipeline_jax_stream(imgs, opts, batch_size)
        enc = max(enc, mp / (_t.perf_counter() - t0))
    cis2 = [deserialize(b) for b in blobs]
    outs = decode_pipeline_jax_stream(cis2, batch_size)  # warm
    dec = 0.0
    for _ in range(reps):
        t0 = _t.perf_counter()
        outs = decode_pipeline_jax_stream(cis2, batch_size)
        dec = max(dec, mp / (_t.perf_counter() - t0))
    for i in range(n):
        np.testing.assert_array_equal(outs[i].data, corpus[i])
    return enc, dec


def bench_device(corpus: np.ndarray, reps: int = 4, batch_size: int = 64):
    """Device-compute MP/s: the fused encode/decode programs timed with
    pre-staged device inputs and blocked outputs — no host transfers or
    container work. Returns (enc_mp_s, dec_mp_s)."""
    import time as _t

    import jax.numpy as jnp

    from frave_tpu import RasterImage
    from frave_tpu.codec.options import quantization_matrix
    from frave_tpu.codec.pipeline_jax import (
        _encode_dispatch,
        _encode_finish,
        _qdiv_array,
        assemble_wire_batch,
        get_program,
        pick_lut_bits,
    )
    from frave_tpu.fractal.geometry import BASE_FRAC_DEPTH

    opts = _bench_opts()
    n, h, w, c = corpus.shape
    b = min(batch_size, n)
    imgs = [RasterImage.from_array(corpus[i]) for i in range(b)]
    mp = b * h * w / 1e6

    prog, packed_dev, qm, meta = _encode_dispatch(imgs, opts)
    cis = _encode_finish(prog, packed_dev, qm, meta, opts)
    pixels = jnp.asarray(
        np.stack([im.data.reshape(-1, c) for im in imgs])
    ).block_until_ready()
    qdiv = jnp.asarray(_qdiv_array(qm, BASE_FRAC_DEPTH))
    tids = jnp.asarray(np.asarray(meta[1], dtype=np.int32))
    enc = 0.0
    for _ in range(reps):
        t0 = _t.perf_counter()
        packed, hist = prog.encode_exec(pixels, qdiv, None, tids)
        packed.block_until_ready()
        enc = max(enc, mp / (_t.perf_counter() - t0))

    nl = cis[0].num_lanes
    dprog = get_program(h, w, BASE_FRAC_DEPTH, nl, c, cis[0].mode)
    wire = assemble_wire_batch(cis, nl)
    lut_bits = pick_lut_bits(wire[2])
    dev = [jnp.asarray(a) for a in wire]
    for a in dev:
        a.block_until_ready()
    dec = 0.0
    for _ in range(reps):
        t0 = _t.perf_counter()
        px = dprog.decode_exec(*dev, lut_bits)
        px.block_until_ready()
        dec = max(dec, mp / (_t.perf_counter() - t0))
    # lossless sanity on the timed program's own output
    got = np.asarray(px)
    want = np.stack([im.data.reshape(-1, c).T for im in imgs])
    np.testing.assert_array_equal(got, want)
    return enc, dec


def bench_native_baseline(corpus: np.ndarray, reps: int = 3) -> float:
    """Single-thread C reference baseline (csrc/refbase.cpp), faithful
    per-image geometry rebuild. Lossless-verified inside the call."""
    from frave_tpu.native import refbase_roundtrip

    if refbase_roundtrip(corpus[0]) is None:  # also warms code paths
        return bench_numpy_baseline(corpus[0])
    n = min(len(corpus), 4)
    mp = n * corpus.shape[1] * corpus.shape[2] / 1e6
    best = 0.0
    for _ in range(reps):
        total = 0.0
        for i in range(n):
            te, td, _ = refbase_roundtrip(corpus[i])
            total += te + td
        best = max(best, mp / total)
    return best


def bench_numpy_baseline(image: np.ndarray) -> float:
    from frave_tpu import EncoderOptions
    from frave_tpu.codec.decoder import FRIDecoder
    from frave_tpu.codec.encoder import FRIEncoder

    enc = FRIEncoder(EncoderOptions(backend="numpy"))
    dec = FRIDecoder(backend="numpy")
    h, w = image.shape[:2]
    t0 = time.perf_counter()
    blob = enc.encode(image)
    out = dec.decode(blob)
    dt = time.perf_counter() - t0
    np.testing.assert_array_equal(out.data, image)
    return (h * w / 1e6) / dt


def main():
    from frave_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = require_gpu()
    h = w = 256
    # 256 images = 4 pipelined 64-batches: enough batches that the
    # threaded round-trip pipeline's steady state dominates ramp-up
    corpus = make_corpus(256, h, w, 1, seed=42)
    value = bench_jax(corpus)
    value_dv = bench_jax(corpus, reps=3, device_verify=True)
    baseline = bench_native_baseline(corpus)
    enc_mp, dec_mp = bench_split(corpus)
    dev_enc, dev_dec = bench_device(corpus)
    out = {
        "metric": "encode+decode throughput, 256x256 gray, jax backend",
        "value": round(value, 4),
        "unit": "MP/s",
        "vs_baseline": round(value / baseline, 4) if baseline > 0 else None,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "card": card_info(),
        # losslessness checked on device: no decoded-pixel fetch
        "value_device_verify": round(value_dv, 4),
        "vs_baseline_device_verify": (
            round(value_dv / baseline, 4) if baseline > 0 else None
        ),
        # encode-only / decode-only wall clock
        "encode_mp_s": round(enc_mp, 3),
        "decode_mp_s": round(dec_mp, 3),
        # pre-staged device compute, no host transfers
        "device_encode_mp_s": round(dev_enc, 3),
        "device_decode_mp_s": round(dev_dec, 3),
        "device_roundtrip_mp_s": round(
            1.0 / (1.0 / dev_enc + 1.0 / dev_dec), 3
        ),
    }
    real = load_real_corpus(64, h, w)
    if real is None:
        out["real_corpus"] = "not available"
    else:
        real_mp = bench_jax(real, reps=3)
        real_base = bench_native_baseline(real)
        real_enc, real_dec = bench_split(real, reps=2)
        rdev_enc, rdev_dec = bench_device(real)
        rdev_rt = 1.0 / (1.0 / rdev_enc + 1.0 / rdev_dec)
        real_dv = bench_jax(real, reps=3, device_verify=True)
        out["real_corpus_mp_s"] = round(real_mp, 4)
        out["real_vs_baseline"] = (
            round(real_mp / real_base, 4) if real_base > 0 else None
        )
        out["real_encode_mp_s"] = round(real_enc, 3)
        out["real_decode_mp_s"] = round(real_dec, 3)
        out["real_device_encode_mp_s"] = round(rdev_enc, 3)
        out["real_device_decode_mp_s"] = round(rdev_dec, 3)
        out["real_device_roundtrip_mp_s"] = round(rdev_rt, 3)
        out["real_device_vs_baseline"] = (
            round(rdev_rt / real_base, 2) if real_base > 0 else None
        )
        out["real_corpus_device_verify_mp_s"] = round(real_dv, 4)
        out["real_vs_baseline_device_verify"] = (
            round(real_dv / real_base, 4) if real_base > 0 else None
        )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
