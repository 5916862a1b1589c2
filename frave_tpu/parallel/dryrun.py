"""Multi-chip dry run: one fully-sharded encode step on tiny shapes.

Used by __graft_entry__.dryrun_multichip — the driver executes this on an
n-device virtual CPU mesh to validate that the dp x tp shardings compile
and run without real chips (SURVEY.md section 4, distributed test plan).
"""

from __future__ import annotations

import numpy as np


def run_dryrun(n_devices: int) -> None:
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n_devices}"
        ).strip()

    import jax

    # The dry run always uses the virtual CPU devices, also in a process
    # whose default backend is an accelerator.
    devs = jax.devices("cpu")
    if len(devs) < n_devices:
        raise RuntimeError(
            f"dryrun wants {n_devices} devices, jax sees {len(devs)}"
        )

    from ..codec.decoder import FRIDecoder
    from ..codec.options import EncoderOptions
    from .mesh import make_mesh
    from .sharded import ShardedDecoder, ShardedEncoder, TPShardedDecoder

    mesh = make_mesh(n_devices, devices=devs)
    dp = mesh.shape["dp"]

    h = w = 32
    C = 1
    B = dp * 2  # two images per dp shard
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 256, size=(B, h, w, C), dtype=np.uint8)

    # dp x tp encode with the ppermute boundary-halo exchange
    enc = ShardedEncoder(height=h, width=w, channels=C, batch=B, mesh=mesh)
    blobs = enc.encode_batch(batch, EncoderOptions())
    assert len(blobs) == B

    # SPMD dp decode: one shard_map program over the whole mesh
    dec = ShardedDecoder(height=h, width=w, channels=C, mesh=mesh)
    outs = dec.decode_batch(blobs)
    for i in range(B):
        np.testing.assert_array_equal(outs[i].data, batch[i])

    # tp decode of a single image: lanes sharded over every device, one
    # all_gather per wavefront step
    from ..codec.encoder import FRIEncoder

    blob1 = FRIEncoder(
        EncoderOptions(backend="jax", num_lanes=max(16, n_devices) * 8)
    ).encode(batch[0])
    tdec = TPShardedDecoder(height=h, width=w, channels=C, mesh=mesh)
    out1 = tdec.decode(blob1)
    np.testing.assert_array_equal(out1.data, batch[0])

    # host-oracle cross-check of the sharded encode bitstream
    out = FRIDecoder(backend="numpy").decode(blobs[0])
    np.testing.assert_array_equal(out.data, batch[0])

    # both wire layouts through the same dp x tp sharded paths: the
    # default legs above run mode=grid (the round-4 default), this leg
    # validates the parallel (step-tensor) wire too
    genc = ShardedEncoder(
        height=h, width=w, channels=C, batch=B, mesh=mesh, mode="parallel"
    )
    gblobs = genc.encode_batch(batch, EncoderOptions(mode="parallel"))
    gouts = dec.decode_batch(gblobs)
    for i in range(B):
        np.testing.assert_array_equal(gouts[i].data, batch[i])
