"""frave_tpu — a fractal-wavelet lossless image codec in JAX.

A from-scratch JAX/XLA re-design with the capabilities of the
reference Rust codec ``pagmerek/frave`` (libfri/fri-cli): tame-twindragon
fractal tiling, per-tile Haar-style lifting wavelets, learned causal
linear predictors, Laplace-context binning, and interleaved multi-stream
rANS entropy coding into a self-describing container.

Architecture (dense array programs, not a port):
  * All geometry (tiling, tile trees, neighbour lattice, canonical order,
    decode wavefront) is precomputed on host as index tensors
    (``frave_tpu.fractal``) — every per-pixel stage is a dense array
    program on device.
  * The entropy-coder stream layout is designed for parallel decode:
    symbols are laid out along a static dependency-wavefront schedule and
    round-robined over N interleaved rANS lanes, so decode is a
    ``lax.scan`` over wavefront steps with all lanes advancing at once.
  * Multi-device scaling uses ``jax.sharding``/``shard_map`` with XLA
    collectives (psum for global context histograms and Gram-matrix
    predictor fits, gathers for cross-tile halos).

Public API mirrors the reference drivers (reference: encoder.rs:87-109,
decoder.rs:48-59).
"""

__version__ = "0.1.0"

from .images import (
    ColorSpace,
    FractalVariant,
    ImageMetadata,
    RasterImage,
    CompressedImage,
    ChannelData,
)
from .codec.options import EncoderOptions, EncoderQuality
from .codec.encoder import FRIEncoder, encode
from .codec.decoder import FRIDecoder, decode

__all__ = [
    "ColorSpace",
    "FractalVariant",
    "ImageMetadata",
    "RasterImage",
    "CompressedImage",
    "ChannelData",
    "EncoderOptions",
    "EncoderQuality",
    "FRIEncoder",
    "FRIDecoder",
    "encode",
    "decode",
]
