"""Encoder options and quality presets.

Reference: encoder.rs:51-80. The reference declares EncoderQuality but
never reads it (the quantization matrix is hardcoded all-ones,
quantization.rs:3-5) — here the knob is functional: each preset selects a
per-tree-layer quantization table. LOSSLESS keeps the all-ones table and
guarantees bit-exact round trips.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class EncoderQuality(enum.Enum):
    LOW = 0
    MEDIUM = 1
    HIGH = 2
    LOSSLESS = 3


# Per-tree-layer divisors, layer = floor(log2(haar_index + 1)) in [0, 10]
# for depth 9 (quantization.rs:16); padded to 32 entries like the
# reference's matrix. Coarse layers (DC, root) stay exact; fine layers
# (leaf differences) quantize harder at lower quality.
_QUANT_TABLES = {
    EncoderQuality.LOSSLESS: [1] * 32,
    EncoderQuality.HIGH: [1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 3] + [3] * 21,
    EncoderQuality.MEDIUM: [1, 1, 1, 1, 1, 2, 2, 3, 4, 6, 8] + [8] * 21,
    EncoderQuality.LOW: [1, 1, 2, 2, 3, 4, 6, 8, 12, 16, 24] + [24] * 21,
}


def quantization_matrix(quality: EncoderQuality) -> np.ndarray:
    return np.asarray(_QUANT_TABLES[quality], dtype=np.int32)


@dataclasses.dataclass
class EncoderOptions:
    """Reference EncoderOpts (encoder.rs:58-80).

    emit_coefficients / verbose keep their reference meaning but emit via
    the in-memory metrics sink (frave_tpu/metrics.py) instead of
    unconditional ./mse and ./coefficients file side-channels
    (prediction.rs:17-37,300 — a quirk deliberately not replicated).
    """

    quality: EncoderQuality = EncoderQuality.LOSSLESS
    emit_coefficients: bool = False
    verbose: bool = False
    num_lanes: Optional[int] = None  # None -> heuristic from symbol count
    backend: str = "auto"  # "jax" | "numpy" | "auto"
    # Context-model mode (frave_tpu/fractal/schedule.py):
    #   "grid" (default since round 4) — parallel-mode contexts on the
    #       dense lattice-grid coefficient layout (fractal/lattice.py):
    #       rANS lanes are packed per-wave grid rows, so the decode scan
    #       body is gather-free (codec/grid_decode.py). Same rate model
    #       as "parallel", different wire lane order (container encoding
    #       2). It beat "parallel" on decode at both 256^2 gray and
    #       2048^2 RGB on the hardware first measured (not yet
    #       re-measured on a GPU). Tiny shapes (< ~32 px a
    #       side) keep the grid wire but decode via the step-tensor
    #       path (no exact lattice parent maps there).
    #   "parallel" — all 6 neighbour taps at parent resolution; each
    #       level decodes as one wave; step-tensor scan decode.
    #   "parity"   — the reference's causal same-level taps
    #       (context_modeling.rs:25-77); decode follows the dependency
    #       wavefront. Better compression on some content, ~10-20x more
    #       decode steps.
    mode: str = "grid"
    # RGB coding transform (codec/channel_transform.py): "auto" (default,
    # reversible subtract-green), or "none"
    color_transform: str = "auto"
    # External predictor-parameter injection (reference
    # EncoderOpts.value_prediction_params, encoder.rs:58-64): when set,
    # the in-encoder least-squares fit is skipped and these parameters are
    # used (and serialized) verbatim — pins a fit for reproduction or lets
    # an outer search (cli optimize) drive the encoder. Shapes [n, 6]
    # (single channel) or [C, n, 6]; f32, where n is either 3 (legacy
    # coarse groups, expanded per level by the pipelines) or the
    # schedule's num_fine (format v8 per-level rows). Parameters travel
    # as f16 on the wire and are rounded accordingly before use.
    value_prediction_params: Optional[np.ndarray] = None
    width_prediction_params: Optional[np.ndarray] = None

    def prediction_overrides(self, channels: int):
        """Normalized ([C,n,6] f32 vp, wp, use_flag) for the pipelines.
        Both-or-neither: a value override without a width override keeps
        the width fit (widths only shape rate, never correctness)."""
        if self.value_prediction_params is None:
            return None

        vref = np.asarray(self.value_prediction_params)
        nrows = vref.shape[-2]

        def norm(p):
            if p is None:
                return np.zeros((channels, nrows, 6), dtype=np.float32)
            a = np.asarray(p, dtype=np.float32)
            if a.shape == (nrows, 6):
                a = np.broadcast_to(a, (channels, nrows, 6))
            if a.shape != (channels, nrows, 6):
                raise ValueError(
                    f"prediction params must be [{nrows},6] or "
                    f"[{channels},{nrows},6]"
                )
            return np.ascontiguousarray(a)

        return norm(self.value_prediction_params), norm(
            self.width_prediction_params
        ), self.width_prediction_params is not None
