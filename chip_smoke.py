"""Smoke run of the frave codec on NVIDIA GPUs.

Drives the codec's user entry points at real widths on the card and
checks every result: lossless round trips, and cross-decoding against
the two independent decoders that define the format (the numpy pipeline
``codec/pipeline_np.py`` and the C++ ``csrc/frif.cpp``), in both
directions. Phases, all in this one process:

  a. device check: JAX must find a GPU; the native library is built
     (``make -C csrc``) and must load;
  b. one 2048x2048 RGB photo: ``frave_tpu.encode``/``decode`` on the
     GPU, decoded by the C++ decoder, and a C++-encoded container
     decoded on the GPU;
  c. 256 grayscale 256x256 images in batches of 64 through
     ``roundtrip_pipeline_jax_stream``; every 8th container is also
     decoded by the numpy pipeline and the C++ decoder;
  d. 512x512 RGB at qualities HIGH and LOW, ``color_transform="trial"``
     and ``mode="parallel"``/``"parity"``: GPU pixels must equal the
     numpy decoder's for the same container; a numpy-encoded container
     is decoded on the GPU;
  e. the golden containers in ``tests/data`` decoded on the GPU;
  f. the chip-marked tests, run in this process.

``--multi`` runs only the four-GPU phase instead: one 4096x4096 RGB
image encoded by ``ShardedEncoder`` and decoded by ``TPShardedDecoder``
on a (dp=1, tp=4) mesh, cross-decoded by the C++ decoder.

Times printed on the way are smoke timings of first calls, compilation
included: they are not benchmark numbers. The last line of standard
output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
printed only when every phase passed. Without a GPU, or if any phase
fails, the script exits non-zero and prints no such line.

    python3 chip_smoke.py            # phases a-f on one GPU
    python3 chip_smoke.py --multi    # the sharded phase on four GPUs
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = ("v7_gray", "v7_rgb", "v8_gray", "v8_rgb", "v9grid_gray", "v9grid_rgb")


def check_device(n_devices: int):
    """Phase a: the first JAX device is a GPU, there are enough of them,
    and the native library (the C++ cross-decoder) builds and loads.
    Returns the device list; exits non-zero otherwise."""
    from bench import require_gpu

    devs = require_gpu()
    if len(devs) < n_devices:
        sys.exit(f"needs {n_devices} GPUs, JAX found {len(devs)}")
    from frave_tpu.native import get_lib

    if get_lib() is None:
        sys.exit("the native library did not build or load (make -C csrc)")
    return devs


def peak_bytes(dev):
    """The device's peak_bytes_in_use (None where the backend keeps no
    memory statistics, as the CPU does)."""
    stats = dev.memory_stats()
    return stats["peak_bytes_in_use"] if stats else None


def _same(got, want, what: str) -> None:
    if got is None:
        raise AssertionError(f"{what}: no output")
    got = np.asarray(got)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    bad = int(np.count_nonzero(got != want))
    if bad:
        raise AssertionError(f"{what}: {bad} samples differ")


def phase_photo(img: np.ndarray) -> dict:
    """Phase b: one RGB photo, lossless, GPU <-> C++ in both directions.
    The container size must be within 5% of the CPU encoder's (the
    numpy pipeline): predictor fits differ slightly between backends, so
    the bytes may differ, the rate may not."""
    import frave_tpu
    from frave_tpu.native import frif_decode_native, frif_encode_native

    blob = frave_tpu.encode(img, frave_tpu.EncoderOptions(backend="jax"))
    _same(frave_tpu.decode(blob, backend="jax").data, img, "gpu encode -> gpu decode")
    _same(frif_decode_native(blob), img, "gpu encode -> c++ decode")
    cblob = frif_encode_native(img)
    _same(frave_tpu.decode(cblob, backend="jax").data, img, "c++ encode -> gpu decode")
    cpu_bytes = len(frave_tpu.encode(img, frave_tpu.EncoderOptions(backend="numpy")))
    if abs(len(blob) / cpu_bytes - 1.0) > 0.05:
        raise AssertionError(
            f"container size {len(blob)} B is not within 5% of the CPU "
            f"encoder's {cpu_bytes} B"
        )
    return {"container_bytes": len(blob), "cpu_container_bytes": cpu_bytes}


def phase_batch(corpus: np.ndarray, batch_size: int, every: int) -> dict:
    """Phase c: a same-shape corpus through the pipelined round trip;
    every `every`-th container is also decoded by numpy and C++."""
    from frave_tpu import EncoderOptions, RasterImage
    from frave_tpu.codec.container import deserialize
    from frave_tpu.codec.pipeline_jax import roundtrip_pipeline_jax_stream
    from frave_tpu.codec.pipeline_np import decode_pipeline_np
    from frave_tpu.native import frif_decode_native

    imgs = [RasterImage.from_array(x) for x in corpus]
    blobs, outs = roundtrip_pipeline_jax_stream(
        imgs, EncoderOptions(backend="jax"), batch_size=batch_size
    )
    if len(blobs) != len(corpus) or len(outs) != len(corpus):
        raise AssertionError(f"{len(outs)} of {len(corpus)} images came back")
    for i, x in enumerate(corpus):
        _same(outs[i].data, x, f"image {i}: gpu round trip")
    for i in range(0, len(corpus), every):
        _same(decode_pipeline_np(deserialize(blobs[i])).data, corpus[i],
              f"image {i}: gpu encode -> numpy decode")
        _same(frif_decode_native(blobs[i]), corpus[i],
              f"image {i}: gpu encode -> c++ decode")
    return {"images": len(corpus), "bytes": sum(len(b) for b in blobs)}


def phase_paths(img: np.ndarray) -> dict:
    """Phase d: lossy qualities and the user-selectable paths. The GPU's
    pixels must equal the numpy decoder's for every container; lossless
    ones must also equal the input."""
    from frave_tpu import EncoderOptions, EncoderQuality, RasterImage
    from frave_tpu.codec.container import deserialize, serialize
    from frave_tpu.codec.encoder import FRIEncoder
    from frave_tpu.codec.pipeline_jax import (
        decode_pipeline_jax_batch,
        encode_pipeline_jax_batch,
    )
    from frave_tpu.codec.pipeline_np import decode_pipeline_np, encode_pipeline_np

    im = RasterImage.from_array(img)
    cases = [
        ("quality=HIGH", EncoderOptions(backend="jax", quality=EncoderQuality.HIGH)),
        ("quality=LOW", EncoderOptions(backend="jax", quality=EncoderQuality.LOW)),
        ("color_transform=trial", EncoderOptions(backend="jax", color_transform="trial")),
        ("mode=parallel", EncoderOptions(backend="jax", mode="parallel")),
        ("mode=parity", EncoderOptions(backend="jax", mode="parity")),
    ]
    sizes = {}
    for name, opts in cases:
        if opts.color_transform == "trial":
            blob = FRIEncoder(opts).encode(im)
        else:
            blob = serialize(encode_pipeline_jax_batch([im], opts)[0])
        ci = deserialize(blob)
        got = decode_pipeline_jax_batch([ci])[0].data
        _same(got, decode_pipeline_np(ci).data, f"{name}: gpu vs numpy decode")
        if opts.quality == EncoderQuality.LOSSLESS:
            _same(got, img, f"{name}: lossless")
        sizes[name] = len(blob)
    nblob = serialize(encode_pipeline_np(im, EncoderOptions(backend="numpy")))
    _same(decode_pipeline_jax_batch([deserialize(nblob)])[0].data, img,
          "numpy encode -> gpu decode")
    return sizes


def phase_golden(data_dir: str) -> dict:
    """Phase e: every golden container decodes on the GPU to its pixels."""
    import frave_tpu

    for name in GOLDEN:
        with open(os.path.join(data_dir, f"{name}.frv"), "rb") as f:
            blob = f.read()
        want = np.load(os.path.join(data_dir, f"{name}.npy"))
        _same(frave_tpu.decode(blob, backend="jax").data, want, f"golden {name}")
    return {"containers": len(GOLDEN)}


def phase_chip_tests() -> dict:
    """Phase f: the chip-marked tests, in this process so that the card
    stays with one process. Fails if any test fails or skips, or if none
    ran."""
    import pytest

    os.environ["FRAVE_TEST_GPU"] = "1"

    class Tally:
        def __init__(self):
            self.outcomes = {}

        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                self.outcomes[report.outcome] = self.outcomes.get(report.outcome, 0) + 1

    tally = Tally()
    rc = pytest.main(
        [os.path.join(REPO, "tests", "test_chip.py"), "-q", "-m", "chip",
         "-p", "no:cacheprovider", "-p", "no:randomly"],
        plugins=[tally],
    )
    passed = tally.outcomes.get("passed", 0)
    if rc != 0 or passed == 0 or len(tally.outcomes) != 1:
        raise AssertionError(f"chip tests: exit {rc}, outcomes {tally.outcomes}")
    return {"passed": passed}


def phase_multi(img: np.ndarray, devs) -> dict:
    """The four-GPU phase: one image sharded over a (dp=1, tp=n) mesh."""
    from frave_tpu import EncoderOptions
    from frave_tpu.native import frif_decode_native
    from frave_tpu.parallel.mesh import make_mesh
    from frave_tpu.parallel.sharded import ShardedEncoder, TPShardedDecoder

    h, w, c = img.shape
    n = len(devs)
    mesh = make_mesh(n, shape=(1, n), devices=devs)
    enc = ShardedEncoder(height=h, width=w, channels=c, batch=1, mesh=mesh)
    blob = enc.encode_batch(img[None], EncoderOptions())[0]
    dec = TPShardedDecoder(height=h, width=w, channels=c, mesh=mesh)
    _same(dec.decode(blob).data, img, "sharded encode -> sharded decode")
    _same(frif_decode_native(blob), img, "sharded encode -> c++ decode")
    peaks = [peak_bytes(d) for d in devs]
    if 0 in peaks:
        raise AssertionError(f"a device held no data: {peaks}")
    info = {"container_bytes": len(blob), "peak_bytes_in_use": peaks}
    if None not in peaks:
        # near 1 when the image is split evenly; far above it when the
        # work sits on device 0
        info["peak_dev0_over_max_other"] = peaks[0] / max(peaks[1:])
    return info


class _CompileClock:
    """Sums JAX's compile-event durations (tracing, lowering, backend
    compile) so each phase can report its compile time."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, secs, **kwargs):
        if name.startswith("/jax/core/compile/"):
            self.seconds += secs


def _run(name: str, clock: _CompileClock, dev, fn, *args) -> None:
    c0 = clock.seconds
    t0 = time.perf_counter()
    info = fn(*args)
    wall = time.perf_counter() - t0
    peak = peak_bytes(dev)
    print(
        f"smoke timing {name}: wall {wall:.3f} s, compile "
        f"{clock.seconds - c0:.3f} s, peak_bytes_in_use {peak} | "
        f"{json.dumps(info)}",
        flush=True,
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--multi",
        action="store_true",
        help="run only the sharded phase on four GPUs",
    )
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    from frave_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    from bench import card_info, make_corpus

    n_dev = 4 if args.multi else 1
    t0 = time.perf_counter()
    devs = check_device(n_dev)[:n_dev]
    dev = devs[0]
    clock = _CompileClock()
    print(
        f"smoke timing a. device check: wall {time.perf_counter() - t0:.3f} s "
        f"| {dev.device_kind} x{len(devs)}",
        flush=True,
    )
    if args.multi:
        img = make_corpus(1, 4096, 4096, 3, seed=0)[0]
        _run("multi. 4096x4096 RGB over 4 GPUs", clock, dev,
             phase_multi, img, devs)
    else:
        _run("b. 2048x2048 RGB", clock, dev, phase_photo,
             make_corpus(1, 2048, 2048, 3, seed=0)[0])
        _run("c. 256 x 256x256 gray, batches of 64", clock, dev, phase_batch,
             make_corpus(256, 256, 256, 1, seed=1), 64, 8)
        _run("d. 512x512 RGB paths", clock, dev, phase_paths,
             make_corpus(1, 512, 512, 3, seed=2)[0])
        _run("e. golden containers", clock, dev, phase_golden,
             os.path.join(REPO, "tests", "data"))
        _run("f. chip-marked tests", clock, dev, phase_chip_tests)
    print(f"card: {card_info()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": n_dev,
    }}))


if __name__ == "__main__":
    main()
