"""JAX/XLA codec pipeline — the device compute path.

Stage flow mirrors the reference drivers (encoder.rs:6-49, decoder.rs:6-42)
but is organized around XLA's compilation model and the cost of
host<->device round trips (SURVEY.md section 7):

  * Geometry + wavefront schedule are host-precomputed index tensors
    (frave_tpu/fractal/) uploaded once per `CodecProgram` and passed to the
    jitted stages as device-resident arguments.
  * Encode is ONE fused device program: leaf gather -> lifting ->
    quantization -> Gram-matrix predictor fit (Cholesky solve of the 6x6
    normal equations on device — the device replacement of the
    reference's dense lstsq, context_modeling.rs:168,185) -> contexts ->
    zig-zag symbols -> per-bucket histograms -> context-table finalization
    ON DEVICE (frave_tpu/entropy/tables_jax.py, exact twin of the host
    tables) -> vectorized reverse-scan rANS over all lanes -> per-lane
    stream compaction -> ONE packed int32 output vector. A single
    device->host fetch returns everything the container needs; every
    fetch is a synchronizing round trip, so small images are bounded by
    their fetch count.
  * Decode is a single lax.scan over wavefront steps: every step gathers
    causal neighbours, recomputes contexts (identical f32 op sequence as
    encode — the self-consistency contract of entropy_coding.rs:205-264),
    advances all rANS lanes of all channels once (ONE merged-table
    gather + one-hot contractions, see rans_jax.decode_step_merged),
    scatters decoded coefficients; then
    dequantizes, inverse-lifts and emits pixels — one fetch.
  * Batching: same-shape images vmap over a leading batch axis, so a
    corpus pays the fetch latency once per batch, not per image.

Numerical notes: the predictor fit uses f32 Gram matrices on device (the
numpy oracle uses f64 + SVD lstsq) — fitted parameters differ slightly
between backends, which only shifts bitstream size, never correctness:
the exact f32 parameters used travel in the container (serialize.rs:78-92
analog) and both decoders consume them identically.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..images import (
    AnsContextTables,
    ChannelData,
    CompressedImage,
    RasterImage,
)
from ..entropy.tables import (
    ALPHABET_SIZE,
    CONTEXT_AMOUNT,
    ENC_FREQ_BITS_CAP,
    _GRID_LOG2,
    _LAPLACE_GRID_ROWS,
)
from ..entropy.tables_jax import finalize_contexts_device, select_scales_device
from ..fractal.geometry import BASE_FRAC_DEPTH, get_geometry
from ..fractal.schedule import (
    default_num_lanes,
    get_lane_steps,
    get_schedule,
    rate_adaptive_lanes,
)
from ..ops import jax_ops as J
from ..ops.rans_jax import (
    LUT_BITS,
    SCAN_UNROLL,
    build_merged_decode_table,
    decode_step_merged,
    encode_scan,
    stream_compact,
    stream_compact_grid,
    stream_compact_scatter,
)
from .options import EncoderOptions, quantization_matrix


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def pick_lut_bits(wire_bits: np.ndarray) -> int:
    """Merged decode-table size for a batch: the encoder cap for streams
    this encoder produced, the legacy wire max for older (13/14-bit)
    containers — at most two compiled program variants per shape."""
    return (
        ENC_FREQ_BITS_CAP
        if int(np.asarray(wire_bits).max()) <= ENC_FREQ_BITS_CAP
        else LUT_BITS
    )


def _gram_solve(G: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Regularized Cholesky solve of batched 6x6 normal equations."""
    tr = jnp.trace(G, axis1=-2, axis2=-1)
    eps = tr * 1e-6 / 6.0 + 1e-12
    Greg = G + eps[..., None, None] * jnp.eye(G.shape[-1], dtype=G.dtype)
    L = jnp.linalg.cholesky(Greg)
    y = jax.scipy.linalg.solve_triangular(L, b[..., None], lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), y, lower=False
    )
    return x[..., 0]


# --- packed 3-channel coefficient plane (RGB fast path) --------------
# Quantized coefficients of 8-bit input are bounded |q| <= 511 (lifting
# sums/differences of [0, 255] pixels; quantization only shrinks), so
# each channel fits a biased 10-bit field and ONE u32 word carries all
# three. The decode scan's per-step 6-neighbour gather and the encoder's
# bulk [C, K, 6] gather are random-access reads whose cost grows with
# the gathered element count, so packing cuts that traffic 3x for RGB.
# Corrupt streams can produce |value| up to 767; the pack clamps, which
# only affects already-garbage pixels (the robustness contract is
# decode-without-crash, not fidelity).
_PACK_BIAS = 512
_PACK_ZERO = int(512 | (512 << 10) | (512 << 20))


def _pack3(v):
    """[3, ...] int32 -> [...] uint32 (biased 10-bit fields)."""
    vc = jnp.clip(v + _PACK_BIAS, 0, 1023).astype(jnp.uint32)
    return vc[0] | (vc[1] << jnp.uint32(10)) | (vc[2] << jnp.uint32(20))


def _unpack3(w):
    """[...] uint32 -> [3, ...] int32."""
    m = jnp.uint32(1023)
    return (
        jnp.stack(
            [
                (w & m).astype(jnp.int32),
                ((w >> jnp.uint32(10)) & m).astype(jnp.int32),
                ((w >> jnp.uint32(20)) & m).astype(jnp.int32),
            ]
        )
        - _PACK_BIAS
    )


def _i32(x):
    return jax.lax.bitcast_convert_type(x, jnp.int32)


# ---- device channel transforms (exact integer twins of codec/
# channel_transform.py, which keeps the host/numpy-backend versions and
# the selection policy; channel_transform.rs:3-10 is the reference's
# identity TODO). The id is a traced per-image scalar so one compiled
# program serves any transform mix in a batch; all four candidates are a
# handful of elementwise int ops over [3, HW] — computing every branch
# and selecting avoids device control flow.


def _sgn8(x):
    """Mod-256 value -> signed representative in [-128, 127] (int32)."""
    return ((x + 128) & 255) - 128


def _transform_device(planes: jnp.ndarray, tid: jnp.ndarray) -> jnp.ndarray:
    """[3, HW] int32 raw RGB -> coding planes by transform id."""
    r, g, b = planes[0], planes[1], planes[2]
    sub = jnp.stack([(r - g) & 255, g, (b - g) & 255])
    subc = jnp.stack(
        [jnp.clip(r - g + 128, 0, 255), g, jnp.clip(b - g + 128, 0, 255)]
    )
    co = (r - b) & 255
    t = (b + (_sgn8(co) >> 1)) & 255
    cg = (g - t) & 255
    y = (t + (_sgn8(cg) >> 1)) & 255
    yco = jnp.stack([y, co, cg])
    allt = jnp.stack([planes, sub, subc, yco])  # [4, 3, HW]
    return jax.lax.dynamic_index_in_dim(allt, tid, 0, keepdims=False)


def _inverse_transform_device(
    planes: jnp.ndarray, tid: jnp.ndarray
) -> jnp.ndarray:
    """Inverse of _transform_device on [3, HW] int32 coding planes."""
    a, g, c = planes[0], planes[1], planes[2]
    add = jnp.stack([(a + g) & 255, g, (c + g) & 255])
    addc = jnp.stack(
        [jnp.clip(a + g - 128, 0, 255), g, jnp.clip(c + g - 128, 0, 255)]
    )
    t = (a - (_sgn8(c) >> 1)) & 255  # y, co, cg = a, g, c
    gg = (c + t) & 255
    b = (t - (_sgn8(g) >> 1)) & 255
    r = (g + b) & 255
    yco = jnp.stack([r, gg, b])
    allt = jnp.stack([planes, add, addc, yco])
    return jax.lax.dynamic_index_in_dim(allt, tid, 0, keepdims=False)


# Packed-output layout (int32 words):
#   per channel: vparams(6*num_fine) wparams(6*num_fine) bits(CA)
#                off_bitmask(CA*32) states(NL)
#   then global: total_words(1) stream(ceil(K*C/2), u16 pairs)
# The fetch is split: the fixed-size header part first (tiny), then a
# host-sliced prefix of the stream sized by the fetched totals — padding
# bytes never cross the device link.
# bits [CA] + off bitmask [CA, 32] + Laplace-grid scale indices [CA] (v9)
_HDR_TABLES = CONTEXT_AMOUNT + CONTEXT_AMOUNT * (ALPHABET_SIZE // 32) + CONTEXT_AMOUNT


@dataclasses.dataclass
class CodecProgram:
    """Compiled codec for one (height, width, depth, num_lanes, channels)."""

    height: int
    width: int
    depth: int
    nl: int
    channels: int
    num_tiles: int
    num_symbols: int
    num_steps: int
    rows: int  # R = ceil(K / NL)
    n_slots: int
    mode: str = "parallel"

    def __post_init__(self):
        h, w, depth, nl, C = (
            self.height,
            self.width,
            self.depth,
            self.nl,
            self.channels,
        )
        geo = get_geometry(h, w, depth)
        sched = get_schedule(h, w, depth, mode=self.mode)
        steps = get_lane_steps(h, w, nl, depth, mode=self.mode)

        T, N = geo.num_tiles, geo.nodes_per_tile
        n_slots = T * N
        K = sched.num_symbols
        R = self.rows
        S = steps.num_steps
        HW = h * w
        KC = K * C
        self.kc = KC
        self.kcp2 = (KC + 1) // 2
        self.num_fine = sched.num_fine
        self.legacy_of_fine = sched.legacy_of_fine.astype(np.int64)
        # + 1: per-channel expected-code-length f32 (rate-adaptive lanes)
        self.chan_hdr = 12 * sched.num_fine + _HDR_TABLES + nl + 1
        self.hdr_words = C * self.chan_hdr + 1  # + global total

        # ---- device-resident geometry/schedule tensors (uploaded once) ----
        pg = geo.pixel_gather.astype(np.int32)  # [T, N]
        put = jax.device_put
        self._enc_args = (
            put(np.where(pg >= 0, pg, 0).astype(np.int32)),  # leaf_safe
            put(pg >= 0),  # leaf_mask
            put(sched.sched_coef.astype(np.int32)),  # sc [K]
            put(
                np.where(
                    sched.sched_nbr >= 0, sched.sched_nbr, n_slots
                ).astype(np.int32)
            ),  # snbr_safe [K, 6]
            put(sched.sched_lf.astype(bool)),  # slf
            put(sched.sched_group.astype(np.int32)),  # sgrp
            put(sched.sched_fbkt.astype(np.int32)),  # sfbkt (-1 = computed)
            # full Laplace grid (v9): rows 0..CA-1 are the legacy
            # per-bucket rows, so legacy wires select row == bucket
            put(_LAPLACE_GRID_ROWS.astype(np.uint32)),  # [NUM_SCALES, 7, 1024]
            put(_GRID_LOG2),  # [NUM_SCALES, 7, 1024] f32 (scale selection)
            put(
                (_LAPLACE_GRID_ROWS == 0).astype(np.float32)
            ),  # zero-mask rows (off-list wire-cost term of the selection)
        )
        self._lap = self._enc_args[-3]
        # static per-group HF k-ranges: the schedule orders symbols by
        # phase/level, so each predictor group occupies one contiguous
        # range — the Gram matrices reduce over static slices (dense dots)
        # instead of materializing masked [C, K, 6] design matrices.
        hf_np = ~sched.sched_lf
        grp_np = sched.sched_group.astype(np.int32)
        self._group_ranges = []
        for g in range(sched.num_fine):
            idx = np.nonzero(hf_np & (grp_np == g))[0]
            if idx.size == 0:
                self._group_ranges.append((0, 0))
                continue
            lo, hi = int(idx.min()), int(idx.max()) + 1
            if idx.size != hi - lo:
                raise AssertionError(
                    f"predictor group {g} not contiguous in schedule"
                )
            self._group_ranges.append((lo, hi))
        group_ranges = self._group_ranges
        from ..fractal.schedule import get_stream_perm

        # decode rank of each row-major [R, C, NL] grid slot —
        # stream_compact's sort key (round 3); padding slots (R*NL
        # rounds K up) rank past every real symbol
        _pm = get_stream_perm(h, w, nl, depth, self.mode, C)
        _rank = np.full(R * C * nl, 1 << 30, dtype=np.int32)
        _rank[_pm] = np.arange(_pm.shape[0], dtype=np.int32)
        self._inv_perm = put(_rank)
        # grid mode (packed rows, round 4): every wave's symbols are
        # CONTIGUOUS in schedule order and fill rows back-to-back, so
        # laying symbols onto the [R, NL] lane grid is per-wave static
        # slicing + tail padding + concat — pure layout ops, no scatter
        # (the round-3 padded-raster layout needed a [C, K] scatter per
        # encode array here)
        if sched.cell_pos is not None:
            from ..fractal.schedule import grid_row_lane

            _, _, _gR, _rpw = grid_row_lane(sched, nl)
            assert _gR == R
            segs = []
            k0 = 0
            for ws, rw in zip(
                sched.wave_sizes.tolist(), _rpw.tolist()
            ):
                segs.append((k0, ws, int(rw) * nl - ws))
                k0 += ws
            self._wave_segs = segs
        else:
            self._wave_segs = None
        # grid-mode stream-compaction strategy (round 5): "rows" =
        # per-row u32 sort + offset scan (rans_jax.stream_compact_grid),
        # "scatter" = prefix sum + one scatter, "sort" = the global
        # (rank, word) two-operand sort. On the hardware this was first
        # tuned on, "rows" won UNBATCHED (the offset scan's
        # dynamic_update_slices are contiguous copies) but lost under
        # vmap (batched dynamic_update_slice lowers to scatter), so the
        # default is per-batch-size: "rows" at B == 1, "sort" for
        # batched encodes (not yet re-measured on a GPU). FRAVE_COMPACT
        # pins one strategy for re-measurement. "rows" needs the in-row
        # rank to fit u16.
        env_mode = os.environ.get("FRAVE_COMPACT")
        if env_mode is None:
            self._compact_for_b = lambda B: (
                "rows" if B == 1 and C * nl <= (1 << 16) else "sort"
            )
        else:
            fixed = (
                "sort"
                if env_mode == "rows" and C * nl > (1 << 16)
                else env_mode
            )
            self._compact_for_b = lambda B: fixed
        st_coef = steps.step_coef.astype(np.int32)
        st_active = st_coef >= 0
        # ---- decode segments (parallel mode): one entry per schedule
        # wave, whose lf/group/fbkt are wave-constant by construction
        # (fractal/schedule.py build_schedule allocates one fine id per
        # contiguous wave) — the gather-free decode hoists neighbour
        # gathers, context math and coefficient scatters out of the rANS
        # scan into per-wave bulk ops (see decode_fused_seg below).
        self._segments = []
        if self.mode == "parallel" and S > 0:
            waves = steps.step_wave
            # zero-size waves (e.g. no B-tiles on a 1-tile image) emit no
            # steps — iterate only waves that actually appear
            for wv in np.unique(waves).tolist():
                idx = np.nonzero(waves == wv)[0]
                s0, s1 = int(idx.min()), int(idx.max()) + 1
                assert np.array_equal(idx, np.arange(s0, s1))
                act0 = st_active[s0]
                grp = int(steps.step_group[s0][act0][0])
                fbkt = int(steps.step_fbkt[s0][act0][0])
                lf = bool(steps.step_lf[s0][act0][0])
                for s in range(s0, s1):
                    a = st_active[s]
                    assert (steps.step_group[s][a] == grp).all()
                    assert (steps.step_fbkt[s][a] == fbkt).all()
                    assert (steps.step_lf[s][a] == lf).all()
                self._segments.append((s0, s1, grp, fbkt, lf))
        # pixel assembly as a GATHER: pixel_gather is a bijection from
        # in-bounds leaves to pixels, so pixels[p] = leaves[pix_inv[p]]
        # (the equivalent [C, HW] scatter was several times slower)
        pgf = pg.reshape(-1)
        inb = pgf >= 0
        pix_inv = np.zeros(HW, dtype=np.int32)
        pix_inv[pgf[inb]] = np.nonzero(inb)[0].astype(np.int32)
        self._dec_args = (
            put(np.where(st_active, st_coef, n_slots).astype(np.int32)),
            put(st_active),
            put(
                np.where(steps.step_nbr >= 0, steps.step_nbr, n_slots).astype(
                    np.int32
                )
            ),
            put(steps.step_lf.astype(bool)),
            put(steps.step_group.astype(np.int32)),
            put(steps.step_fbkt.astype(np.int32)),
            put(pix_inv),  # pixel -> owning leaf (gather indices)
            put(geo.coef_mask.astype(bool)),  # node presence [T, N]
            put(pg >= 0),  # leaf in-bounds [T, N]
        )

        # ------------- fused encode (single image [HW, C]) -------------
        # grid mode swaps the statistics stage for the dense shift-plane
        # path (closure cell rebound below once the dense plans build)
        grid_enc = None

        def encode_fused(
            pixels, tid, qdiv, vp_ovr, wp_ovr, use_ovr, use_wovr,
            leaf_safe, leaf_mask, sc, snbr_safe, slf, sgrp,
            sfbkt, lap, glog2, gzero, inv_perm, compact_mode="sort",
        ):
            # [HW, C] (host-contiguous view, no host transpose) -> [C, HW]
            # int32 coding planes; the channel transform applies ON DEVICE
            # (the host only resolves the policy to an id)
            planes = pixels.T.astype(jnp.int32)
            if C == 3:
                planes = _transform_device(planes, tid)
            leaves = jnp.where(
                leaf_mask[None], planes[:, leaf_safe], 0
            ).astype(jnp.int32)  # [C, T, N]
            with jax.named_scope("lifting"):
                coef = J.forward_lifting(leaves, leaf_mask[None], depth)
                qcoef = J.quantize(coef, qdiv[None, None, :])
            if C == 3:
                # packed u32 plane: ONE bulk gather instead of three (see
                # _pack3) — the [C, K, 6] neighbour read dominates encode
                # at large shapes
                qplane = jnp.concatenate(
                    [
                        _pack3(qcoef.reshape(3, n_slots)),
                        jnp.full((1,), _PACK_ZERO, jnp.uint32),
                    ]
                )
            else:
                # int16 coefficient plane: values are bounded (|coef| <=
                # 511 for 8-bit input, preds clamp at +-255); int16
                # halves the gather's HBM traffic, casts are exact.
                qplane = jnp.concatenate(
                    [
                        qcoef.reshape(C, n_slots).astype(jnp.int16),
                        jnp.zeros((C, 1), jnp.int16),
                    ],
                    axis=1,
                )

            def step_stats():
                """The step-tensor statistics path: bulk neighbour
                gather + per-group Gram fits + vmapped contexts."""
                if C == 3:
                    vals = _unpack3(qplane[snbr_safe])  # [3, K, 6]
                    target = _unpack3(qplane[sc])  # [3, K]
                else:
                    vals = qplane[:, snbr_safe].astype(jnp.int32)
                    target = qplane[:, sc].astype(jnp.int32)  # [C, K]

                # --- predictor fits: per-group Gram over STATIC
                # k-slices (groups are contiguous in schedule order —
                # no masked design matrices, the reductions are plain
                # dense contractions)
                def feats(Xs):
                    return jnp.stack(
                        [
                            jnp.ones(Xs.shape[:-1], Xs.dtype),
                            jnp.abs(Xs[..., 0] - Xs[..., 3]),
                            jnp.abs(Xs[..., 1] - Xs[..., 2]),
                            jnp.abs(Xs[..., 4] - Xs[..., 5]),
                            jnp.abs(Xs[..., 1] - Xs[..., 5]),
                            jnp.abs(Xs[..., 2] - Xs[..., 4]),
                        ],
                        axis=-1,
                    )

                # ALL fit einsums run at HIGHEST precision. Not for fit
                # quality: the fitted params feed BOTH the bucket/symbol
                # computation and the wire headers, and XLA may
                # duplicate this subgraph into the two consumers with
                # different precision decisions per instance (a
                # default-precision einsum may run in bf16 or TF32, and
                # an image encoded that way was once self-INCONSISTENT —
                # the header params differed from the params the symbols
                # were formed with). Exact contractions make every
                # duplicated instance agree; the optimization_barrier
                # below additionally pins ONE materialized value for
                # both consumers.
                _HI = jax.lax.Precision.HIGHEST
                Gs, bs = [], []
                for (lo, hi) in group_ranges:
                    Xs = vals[:, lo:hi].astype(jnp.float32)  # [C, kg, 6]
                    ys = target[:, lo:hi].astype(jnp.float32)
                    Gs.append(
                        jnp.einsum("ckx,cky->cxy", Xs, Xs, precision=_HI)
                    )
                    bs.append(
                        jnp.einsum("ckx,ck->cx", Xs, ys, precision=_HI)
                    )
                G = jnp.stack(Gs, axis=1)  # [C, F, 6, 6]
                bv = jnp.stack(bs, axis=1)
                vparams = _gram_solve(G, bv)  # [C, F, 6]
                # external predictor injection (EncoderOpts.value_
                # prediction_params, encoder.rs:58-64): pin serialized
                # params verbatim; the width fit below then models
                # residuals of the PINNED value predictor
                vparams = jnp.where(use_ovr, vp_ovr, vparams)
                # round to the f16 wire precision BEFORE any residual
                # math — decode recomputes predictions from the wire
                # values. Uses the exact integer-op rounding
                # (J.f16_wire_round), which pins IEEE RNE on every
                # backend (see that helper).
                vparams = jax.lax.optimization_barrier(
                    J.f16_wire_round(vparams)
                )

                Gws, bws = [], []
                for g, (lo, hi) in enumerate(group_ranges):
                    Xs = vals[:, lo:hi].astype(jnp.float32)
                    ys = target[:, lo:hi].astype(jnp.float32)
                    pred_g = jnp.einsum(
                        "ckx,cx->ck", Xs, vparams[:, g], precision=_HI
                    )
                    rg = jnp.abs(ys - pred_g)
                    Fs = feats(Xs)
                    Gws.append(
                        jnp.einsum("ckx,cky->cxy", Fs, Fs, precision=_HI)
                    )
                    bws.append(
                        jnp.einsum("ckx,ck->cx", Fs, rg, precision=_HI)
                    )
                Gw = jnp.stack(Gws, axis=1)
                bw = jnp.stack(bws, axis=1)
                wparams = _gram_solve(Gw, bw)
                wparams = jnp.where(use_wovr, wp_ovr, wparams)
                wparams = jax.lax.optimization_barrier(
                    J.f16_wire_round(wparams)
                )

                # --- contexts + symbols (parallel over all K on encode)
                buckets, preds = jax.vmap(
                    lambda v, vp, wp: J.contexts(v, slf, sgrp, vp, wp)
                )(vals, vparams, wparams)
                buckets = jnp.where(sfbkt[None] >= 0, sfbkt[None], buckets)
                symbols = J.pack_signed(target - preds)  # [C, K] int32
                return vparams, wparams, buckets, symbols

            if grid_enc is not None:
                # dense grid-mode statistics (round 5): shift-plane taps
                # + on-grid contexts + subsampled fits — no [C, K, 6]
                # scattered gather (see grid_decode.build_grid_encode)
                vparams, wparams, buckets, symbols = grid_enc(
                    qplane, vp_ovr, wp_ovr, use_ovr, use_wovr
                )
            else:
                vparams, wparams, buckets, symbols = step_stats()

            if (1 << 20) <= K < (1 << 24):
                # one-hot matmul histogram (round 4): hist[c,b,s] =
                # onehot_bkt[c,:,b] . onehot_sym[c,:,s] — XLA fuses the
                # one-hot generation into the contraction (no [C,K,1024]
                # materialization) and f32 accumulation is exact
                # because counts <= K < 2^24 — the upper bound gates the
                # branch (ADVICE r4): at K >= 2^24 (~4096x4096+) skewed
                # bins would saturate f32 and silently undercount, so
                # those shapes take the exact i32 scatter below. The
                # lower bound K >= 2^20 is an older tuning (the matmul
                # won there only at multi-megapixel shapes), not yet
                # re-decided on a GPU.
                ohb = jnp.asarray(
                    buckets[..., None]
                    == jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32),
                    jnp.bfloat16,
                )
                ohs = jnp.asarray(
                    jnp.clip(symbols, 0, ALPHABET_SIZE - 1)[..., None]
                    == jnp.arange(ALPHABET_SIZE, dtype=jnp.int32),
                    jnp.bfloat16,
                )
                hist = jnp.einsum(
                    "ckb,cks->cbs", ohb, ohs,
                    preferred_element_type=jnp.float32,
                ).astype(jnp.int32)
            else:
                ids = (
                    jnp.arange(C, dtype=jnp.int32)[:, None]
                    * (CONTEXT_AMOUNT * ALPHABET_SIZE)
                    + buckets * ALPHABET_SIZE
                    + jnp.clip(symbols, 0, ALPHABET_SIZE - 1)
                )
                # histogram scatter-add. Alternatives that lost to it on
                # earlier hardware: pre-sorted ids + indices_are_sorted,
                # searchsorted bin-edge counting (per-iteration gathers)
                # and a sort-based count.
                hist = (
                    jnp.zeros(C * CONTEXT_AMOUNT * ALPHABET_SIZE, jnp.int32)
                    .at[ids.reshape(-1)]
                    .add(1)
                    .reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
                )

            # --- context tables on device (exact host twin); v9 first
            # picks the best-fitting Laplace grid scale per context
            scales = select_scales_device(hist, glog2, gzero)
            bits, freqs, cdfs, off_mask = finalize_contexts_device(
                hist, lap, scale_idx=scales
            )

            # exact expected code length under the finalized tables
            # (pipeline_np's est_bits twin, on device): coded symbols
            # always have freq > 0, so hist > 0 implies freq > 0. One
            # f32 word per channel rides the header; the host uses it
            # for the rate-adaptive lane re-encode on flat content
            # (ADVICE r4 — replaces the encode-twice numpy fallback).
            exp_bits = jnp.sum(
                jnp.where(
                    hist > 0,
                    hist.astype(jnp.float32)
                    * (
                        bits.astype(jnp.float32)[..., None]
                        - jnp.log2(
                            jnp.maximum(freqs.astype(jnp.float32), 1.0)
                        )
                    ),
                    0.0,
                ),
                axis=(1, 2),
            )  # [C] f32

            # --- rANS encode over [R, C, NL] grids
            pad = R * nl - K
            wave_segs = self._wave_segs

            if wave_segs is not None:  # grid mode: per-wave slice+pad
                def grid(a, fill):
                    segs = []
                    for (k0, ws, padw) in wave_segs:
                        segs.append(a[:, k0 : k0 + ws])
                        if padw:
                            segs.append(
                                jnp.full((C, padw), fill, dtype=a.dtype)
                            )
                    buf = jnp.concatenate(segs, axis=1)
                    return buf.reshape(C, R, nl).transpose(1, 0, 2)
            else:
                def grid(a, fill):
                    a = jnp.concatenate(
                        [a, jnp.full((C, pad), fill, dtype=a.dtype)],
                        axis=1,
                    )
                    return a.reshape(C, R, nl).transpose(1, 0, 2)

            sym_g = grid(symbols, 0)
            bkt_g = grid(buckets, 0)
            val_g = grid(jnp.ones((C, K), dtype=jnp.bool_), False)
            states, words, flags = encode_scan(
                sym_g,
                bkt_g,
                val_g,
                freqs.astype(jnp.uint32),
                cdfs.astype(jnp.uint32),
                bits,
            )  # [C, NL] u32, [R, C, NL] u16, [R, C, NL] bool

            # --- global-stream compaction (decode order via static perm;
            # grid mode needs no global sort — flat order IS decode
            # order, see stream_compact_grid; strategy is static per
            # compiled program, picked by batch size)
            if wave_segs is not None and compact_mode == "rows":
                stream, total = stream_compact_grid(words, flags, kc=KC)
            elif wave_segs is not None and compact_mode == "scatter":
                stream, total = stream_compact_scatter(
                    words, flags, kc=KC
                )
            else:
                stream, total = stream_compact(
                    words, flags, inv_perm, kc=KC
                )
            if KC % 2:
                stream = jnp.concatenate(
                    [stream, jnp.zeros(1, jnp.uint16)]
                )
            # u16 pairs -> u32 words by BITCAST (byte-identical to the
            # strided s[0::2] | s[1::2] << 16 pack — verified — and a
            # pure reinterpret instead of two strided 12M-element reads)
            spk = jax.lax.bitcast_convert_type(
                stream.reshape(-1, 2), jnp.uint32
            ).reshape(-1)  # [kcp2]

            # --- off bitmask: [C, CA, 1024] -> [C, CA, 32] u32
            om = off_mask.reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE // 32, 32)
            shifts = jnp.arange(32, dtype=jnp.uint32)
            ompk = jnp.sum(
                om.astype(jnp.uint32) << shifts, axis=-1, dtype=jnp.uint32
            )

            # --- packed int32 output: per-channel headers, total, stream
            headers = jnp.concatenate(
                [
                    _i32(vparams).reshape(C, -1),
                    _i32(wparams).reshape(C, -1),
                    bits.astype(jnp.int32),
                    _i32(ompk).reshape(C, -1),
                    scales.astype(jnp.int32),
                    _i32(states),
                    _i32(exp_bits)[:, None],
                ],
                axis=1,
            )  # [C, chan_hdr]
            packed = jnp.concatenate(
                [headers.reshape(-1), total[None], _i32(spk)]
            )
            # hist rides along for observability (per-context entropy,
            # emit_coefficients — prediction.rs:209-218,306-313 analog);
            # it is fetched only when verbose/emit_coefficients ask for it
            return packed, hist

        # ------------- decode (single image) -------------
        def decode_fused(
            states,  # [C, NL] uint32
            stream,  # [W] uint16 global word stream
            wire_bits,  # [C, CA] int32
            offpk,  # [C, CA, 32] uint32 off-list bitmask
            scpk,  # [C, CA] int32 Laplace-grid scale indices (v9 wire)
            vparams,  # [C, F, 6] f32 (F = schedule num_fine)
            wparams,  # [C, F, 6] f32
            qdiv,  # [N] int32
            tid,  # scalar int32 channel-transform id (container byte)
            lap,  # [NUM_SCALES, 7, 1024] u32 Laplace grid
            d_coef,
            d_active,
            d_nbr,
            d_lf,
            d_grp,
            d_fbkt,
            pix_inv,
            node_mask,
            leaf_inb,
            lut_bits=LUT_BITS,
        ):
            # --- regenerate context tables on device (context_from_wire
            # twin: all-zero hist, wire bits, wire off-mask)
            shifts32 = jnp.arange(32, dtype=jnp.uint32)
            off_mask = (
                ((offpk[..., None] >> shifts32) & jnp.uint32(1)) > 0
            ).reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
            zero_hist = jnp.zeros(
                (C, CONTEXT_AMOUNT, ALPHABET_SIZE), jnp.int32
            )
            bits, freqs_i, cdfs_i, _ = finalize_contexts_device(
                zero_hist, lap, bits0=wire_bits, off_mask_in=off_mask,
                scale_idx=scpk,
            )
            # --- ONE merged (sym, freq, cdf) decode table, built with
            # prefix ops only; lut_bits is static per program — the host
            # dispatcher picks 2**ENC_FREQ_BITS_CAP for new streams and
            # falls back to 2**MAX_FREQ_BITS_CAP for legacy wire bits.
            # (Round 3 also built a gather-free compare/one-hot step —
            # ops/rans_jax.decode_step_comparefree, FRAVE_COMPAREFREE=1 —
            # which did not beat the merged-gather step on earlier
            # hardware.)
            use_cmpfree = os.environ.get("FRAVE_COMPAREFREE", "0") == "1"
            if use_cmpfree:
                from ..ops.rans_jax import (
                    decode_step_comparefree,
                    prepare_compare_tables,
                )

                tabs = prepare_compare_tables(cdfs_i, bits)
            else:
                merged = build_merged_decode_table(
                    freqs_i, cdfs_i, bits, lut_bits
                )

            if C == 3:
                # packed u32 plane (see _pack3): per step, ONE [NL, 6]
                # neighbour gather + ONE [NL] scatter instead of three of
                # each. One dummy slot per lane keeps the step's scatter
                # indices provably unique (the schedule writes each slot
                # exactly once; inactive lanes park on their own dummy);
                # missing neighbours read slot n_slots = lane 0's dummy,
                # which always holds the packed zero.
                n_pad = n_slots + nl
                lane_dummy = n_slots + jnp.arange(nl, dtype=jnp.int32)
                qpad0 = jnp.full((n_pad,), _PACK_ZERO, dtype=jnp.uint32)
            else:
                # int16 plane (same bound argument as encode: |unpack_
                # signed(sym <= 1023)| + |pred <= 255| <= 767 even on
                # corrupt streams)
                qpad0 = jnp.zeros((C, n_slots + 1), dtype=jnp.int16)
            gptr0 = jnp.int32(0)

            def body(carry, xs):
                qpad, x, gptr = carry
                coef_safe, active, nbr_safe, lf, grp, fbkt = xs
                if C == 3:
                    vals = _unpack3(qpad[nbr_safe])  # [3, NL, 6]
                else:
                    vals = qpad[:, nbr_safe].astype(jnp.int32)  # [C, NL, 6]
                buckets, preds = jax.vmap(
                    lambda v, vp, wp: J.contexts(
                        v, lf, grp, vp, wp, onehot_params=True
                    )
                )(vals, vparams, wparams)
                buckets = jnp.where(fbkt[None] >= 0, fbkt[None], buckets)
                act = jnp.broadcast_to(active[None], (C, nl))
                if use_cmpfree:
                    oh_bkt = jnp.asarray(
                        buckets[..., None]
                        == jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32),
                        dtype=jnp.bfloat16,
                    )
                    sym, x, gptr = decode_step_comparefree(
                        x, gptr, oh_bkt, active, stream, tabs
                    )
                else:
                    sym, x, gptr = decode_step_merged(
                        x, gptr, buckets, act, stream, merged, bits,
                        lut_bits,
                    )
                values = J.unpack_signed(sym) + preds
                if C == 3:
                    wslot = jnp.where(active, coef_safe, lane_dummy)
                    wval = jnp.where(
                        active, _pack3(values), jnp.uint32(_PACK_ZERO)
                    )
                    qpad = qpad.at[wslot].set(wval, unique_indices=True)
                else:
                    wslot = jnp.where(act, coef_safe[None], n_slots)
                    wval = jnp.where(act, values, 0).astype(jnp.int16)
                    qpad = jax.vmap(lambda q, s, v: q.at[s].set(v))(
                        qpad, wslot, wval
                    )
                return (qpad, x, gptr), None

            (qpad, _, _), _ = jax.lax.scan(
                body,
                (qpad0, states, gptr0),
                (d_coef, d_active, d_nbr, d_lf, d_grp, d_fbkt),
                unroll=min(SCAN_UNROLL, d_coef.shape[0]),
            )
            if C == 3:
                qcoef = _unpack3(qpad[:n_slots]).reshape(C, T, N)
            else:
                qcoef = qpad[:, :n_slots].astype(jnp.int32).reshape(C, T, N)
            with jax.named_scope("inverse_lifting"):
                coef = J.dequantize(qcoef, qdiv[None, None, :])
                leaves = J.inverse_lifting(
                    coef, depth, node_mask[None], leaf_inb[None]
                )
            planes = jnp.clip(leaves.reshape(C, -1)[:, pix_inv], 0, 255)
            # inverse channel transform on device (container transform
            # byte); output stays [C, HW] — fetching the [HW, 3]
            # minor-dim-3 layout was slower than fetching [C, HW] and
            # transposing on host
            if C == 3:
                planes = _inverse_transform_device(planes, tid)
            return planes.astype(jnp.uint8)

        # ------------- gather-free segment decode (parallel mode) ------
        segments = self._segments

        def decode_fused_seg(
            states, stream, wire_bits, offpk, scpk, vparams, wparams,
            qdiv, tid, lap,
            d_coef, d_active, d_nbr, d_lf, d_grp, d_fbkt,
            pix_inv, node_mask, leaf_inb, lut_bits=LUT_BITS,
        ):
            """Round-3 decode redesign. The old scan (decode_fused above)
            pays one batched-index gather and scatter per step, a fixed
            per-step cost on the hardware this was built for. In parallel
            mode every
            schedule wave's symbols depend only on *earlier* waves
            (fractal/schedule.py), so per wave: ONE bulk neighbour gather
            + bulk context math + ONE bulk scatter, and the per-step scan
            body shrinks to the rANS state machine itself — table lookups
            replaced by bf16 one-hot contractions + compares
            (ops/rans_jax.decode_step_comparefree), leaving NO gathers in
            the loop. Replaces the serial decode of
            entropy_coding.rs:354-449."""
            from ..ops.rans_jax import (
                decode_step_comparefree,
                prepare_compare_tables,
            )

            shifts32 = jnp.arange(32, dtype=jnp.uint32)
            off_mask = (
                ((offpk[..., None] >> shifts32) & jnp.uint32(1)) > 0
            ).reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
            zero_hist = jnp.zeros(
                (C, CONTEXT_AMOUNT, ALPHABET_SIZE), jnp.int32
            )
            bits, _, cdfs_i, _ = finalize_contexts_device(
                zero_hist, lap, bits0=wire_bits, off_mask_in=off_mask,
                scale_idx=scpk,
            )
            tabs = prepare_compare_tables(cdfs_i, bits)

            if C == 3:
                # packed u32 plane (see _pack3); bulk scatters may route
                # every inactive lane to ONE shared dummy slot (they all
                # write the packed zero, so collision order is harmless)
                qpad = jnp.full((n_slots + 1,), _PACK_ZERO, jnp.uint32)
            else:
                qpad = jnp.zeros((C, n_slots + 1), dtype=jnp.int16)
            x = states
            gptr = jnp.int32(0)

            for (s0, s1, grp, fbkt, lf) in segments:
                nbr_s = d_nbr[s0:s1]  # [Ss, NL, 6] static slice
                coef_s = d_coef[s0:s1]  # [Ss, NL]
                act_s = d_active[s0:s1]  # [Ss, NL]
                # --- bulk neighbour gather + contexts for the wave
                if C == 3:
                    vals = _unpack3(qpad[nbr_s])  # [3, Ss, NL, 6]
                else:
                    vals = qpad[:, nbr_s].astype(jnp.int32)
                vp_row = vparams[:, grp].reshape(C, 1, 1, 6)
                wp_row = wparams[:, grp].reshape(C, 1, 1, 6)
                buckets, preds = J.contexts_static(
                    vals, vp_row, wp_row, lf
                )  # [C, Ss, NL]
                if fbkt >= 0:
                    buckets = jnp.full_like(buckets, fbkt)
                oh = jnp.asarray(
                    buckets[..., None]
                    == jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32),
                    dtype=jnp.bfloat16,
                ).transpose(1, 0, 2, 3)  # [Ss, C, NL, CA]

                def body(carry, xs):
                    x, gptr = carry
                    oh_t, act_t = xs
                    sym, x, gptr = decode_step_comparefree(
                        x, gptr, oh_t, act_t, stream, tabs
                    )
                    return (x, gptr), sym

                (x, gptr), syms = jax.lax.scan(
                    body, (x, gptr), (oh, act_s)
                )  # syms [Ss, C, NL]
                values = (
                    J.unpack_signed(syms.transpose(1, 0, 2)) + preds
                )  # [C, Ss, NL]
                # --- bulk scatter of the wave's coefficients
                if C == 3:
                    wslot = jnp.where(act_s, coef_s, n_slots).reshape(-1)
                    wval = jnp.where(
                        act_s.reshape(-1),
                        _pack3(values.reshape(3, -1)),
                        jnp.uint32(_PACK_ZERO),
                    )
                    qpad = qpad.at[wslot].set(wval)
                else:
                    wslot = jnp.where(act_s, coef_s, n_slots).reshape(-1)
                    wval = jnp.where(
                        act_s.reshape(1, -1),
                        values.reshape(C, -1),
                        0,
                    ).astype(jnp.int16)
                    qpad = jax.vmap(lambda q, v: q.at[wslot].set(v))(
                        qpad, wval
                    )

            if C == 3:
                qcoef = _unpack3(qpad[:n_slots]).reshape(C, T, N)
            else:
                qcoef = qpad[:, :n_slots].astype(jnp.int32).reshape(C, T, N)
            with jax.named_scope("inverse_lifting"):
                coef = J.dequantize(qcoef, qdiv[None, None, :])
                leaves = J.inverse_lifting(
                    coef, depth, node_mask[None], leaf_inb[None]
                )
            planes = jnp.clip(leaves.reshape(C, -1)[:, pix_inv], 0, 255)
            if C == 3:
                planes = _inverse_transform_device(planes, tid)
            return planes.astype(jnp.uint8)

        self._encode_fused = encode_fused
        # Both decoders are bit-exact twins (same wire). The in-scan
        # variant (decode_fused) was the faster one on the hardware this
        # was first tuned on, where hoisting gathers per wave saved
        # nothing; not yet re-measured on a GPU. The segment path is
        # kept behind FRAVE_SEG_DECODE=1.
        use_seg = (
            os.environ.get("FRAVE_SEG_DECODE", "0") == "1"
            and self.mode == "parallel"
        )
        self._decode_fused = decode_fused_seg if use_seg else decode_fused
        if self.mode == "grid" and os.environ.get(
            "FRAVE_GRID_STEPDEC", "0"
        ) != "1":
            # dense gather-free decode (codec/grid_decode.py): taps are
            # grid shifts, symbols <-> packed lanes is a static bulk
            # gather per wave, the scan body is the bare rANS state
            # machine. FRAVE_GRID_STEPDEC=1 falls back to the
            # step-tensor scan (same wire) for A/B timing.
            from ..fractal.lattice import DenseGridUnavailable
            from .grid_decode import build_grid_decode, build_grid_encode

            try:
                self._decode_fused = build_grid_decode(
                    self, geo, sched, nl, C
                )
                self._grid_dense = True
                # rebind the encode_fused closure cell: grid-mode
                # statistics via shift planes (round 5). Worth it only
                # at large K — the per-wave machinery costs fixed
                # overhead that the one bulk gather beats at small
                # shapes — so the default gates on K (an older threshold,
                # not yet re-decided on a GPU); FRAVE_GRID_ENC:
                # "0" = never, "1" = K-gated default, "force" = always.
                genc = os.environ.get("FRAVE_GRID_ENC", "1")
                kmin = int(
                    os.environ.get("FRAVE_GRID_ENC_MINK", str(1 << 18))
                )
                if genc == "force" or (genc == "1" and K >= kmin):
                    grid_enc = build_grid_encode(self, geo, sched, nl, C)
            except DenseGridUnavailable:
                # tiny shapes (< ~32 px a side): too few cells per
                # mod-4 residue class for the lattice parent-map affine
                # fit (fractal/lattice.py) — the step-tensor decoder
                # handles the same grid wire, just without the dense
                # fast path. Internal consistency AssertionErrors
                # (lane-layout mismatches) propagate (ADVICE r4).
                pass
        self._enc_jit: Dict[int, callable] = {}
        self._dec_jit: Dict[int, callable] = {}
        # jit caches + fetch_guess are touched from the round-trip
        # pipeline's fetch worker threads (roundtrip_pipeline_jax_stream)
        # as well as the main thread; the lock makes the get-or-create
        # races explicit rather than GIL-accidental. fetch_guess itself
        # is a single int store (GIL-atomic, monotone-adaptive) — racing
        # writers only cost one extra fetch, never correctness.
        self._jit_lock = threading.Lock()
        # learned stream-size guess (i32 words) for the single speculative
        # fetch in _encode_finish: folding the header fetch and the
        # stream fetch into one saves a synchronizing round trip
        self.fetch_guess = 0

    # ---------------- batched jit entry points ----------------
    def encode_exec(
        self,
        pixels_b: jnp.ndarray,
        qdiv: jnp.ndarray,
        overrides=None,
        tids=None,
    ):
        """pixels_b: [B, HW, C] uint8 (or int32, host-layout — transposed
        on device) -> (packed [B, hdr_words + kcp2] i32, hist [B, C, CA,
        1024] i32). `overrides` = (vp [C,3,6] or [C,num_fine,6], wp,
        use_w) pins externally-supplied predictor parameters (3-row
        legacy sets expand to the fine ids). `tids`: [B] int32 channel-
        transform ids (applied on device); None = identity."""
        B = pixels_b.shape[0]
        if tids is None:
            tids = jnp.zeros((B,), jnp.int32)
        C = self.channels
        F = self.num_fine
        if overrides is None:
            vp_ovr = jnp.zeros((C, F, 6), jnp.float32)
            wp_ovr = vp_ovr
            use_v = jnp.asarray(False)
            use_w = jnp.asarray(False)
        else:
            vp_np, wp_np, use_w_flag = overrides

            def exp(p):
                p = np.asarray(p, dtype=np.float32)
                if p.shape[-2] == 3 and F != 3:
                    p = p[..., self.legacy_of_fine, :]
                if p.shape[-2:] != (F, 6):
                    raise ValueError(
                        f"override params must have 3 or {F} rows"
                    )
                return p

            vp_ovr = jnp.asarray(exp(vp_np))
            wp_ovr = jnp.asarray(exp(wp_np))
            use_v = jnp.asarray(True)
            use_w = jnp.asarray(bool(use_w_flag))
        with self._jit_lock:
            fn = self._enc_jit.get(B)
            if fn is None:
                # qdiv + overrides(4) + schedule tensors + perm
                n_static = len(self._enc_args) + 6
                cmode = self._compact_for_b(B)
                if B == 1:
                    # unbatched fast path (mirrors decode_exec): a B=1
                    # vmap is not free — batched dynamic_update_slice
                    # lowers to scatter and other ops pick batched
                    # lowerings.
                    def encode_single(pxb, tidb, *rest):
                        packed, hist = self._encode_fused(
                            pxb[0], tidb[0], *rest, compact_mode=cmode
                        )
                        return packed[None], hist[None]

                    fn = jax.jit(encode_single)
                else:
                    fn = jax.jit(
                        jax.vmap(
                            lambda *a: self._encode_fused(
                                *a, compact_mode=cmode
                            ),
                            in_axes=(0, 0) + (None,) * n_static,
                        )
                    )
                self._enc_jit[B] = fn
        return fn(
            pixels_b, tids, qdiv, vp_ovr, wp_ovr, use_v, use_w,
            *self._enc_args, self._inv_perm,
        )

    def decode_exec(
        self, states, stream, wire_bits, offpk, scales, vp, wp, qdiv,
        tids=None, lut_bits: int = LUT_BITS,
    ):
        """Batched (axis 0) wire fields -> pixels [B, C, HW] uint8 (the
        inverse channel transform is applied on device from `tids`, the
        containers' transform bytes). stream: [B, W] u16
        global streams, zero-padded by >= C*nl words past the longest
        stream (decode_step_merged's dynamic_slice contract). qdiv is
        batched ([B, N]) so one batch may mix quality levels /
        quantization matrices — each image dequantizes with its own
        table. lut_bits sizes the merged decode table (static per
        compiled program); every wire_bits value must be <= lut_bits."""
        B = states.shape[0]
        if tids is None:
            tids = jnp.zeros((B,), jnp.int32)
        W = stream.shape[-1]
        key = (B, W, lut_bits)
        with self._jit_lock:
            fn = self._dec_jit.get(key)
            if fn is None:
                dec = self._decode_fused
                if B == 1 and getattr(self, "_grid_dense", False):
                    # unbatched call: B=1 needs no vmap
                    def decode_single(*a):
                        first = [x[0] for x in a[:9]]
                        return dec(*first, *a[9:], lut_bits=lut_bits)[None]

                    fn = jax.jit(decode_single)
                else:
                    fn = jax.jit(
                        jax.vmap(
                            lambda *a: dec(*a, lut_bits=lut_bits),
                            in_axes=(0,) * 9 + (None,) * 10,
                        )
                    )
                self._dec_jit[key] = fn
        return fn(
            states, stream, wire_bits, offpk, scales, vp, wp, qdiv, tids,
            self._lap, *self._dec_args,
        )


_program_cache: Dict[Tuple[int, int, int, int, int, str], CodecProgram] = {}
_cache_lock = threading.Lock()


def get_program(
    height: int, width: int, depth: int, nl: int, channels: int, mode: str = "parallel"
) -> CodecProgram:
    key = (height, width, depth, nl, channels, mode)
    with _cache_lock:
        p = _program_cache.get(key)
    if p is None:
        geo = get_geometry(height, width, depth)
        sched = get_schedule(height, width, depth, mode=mode)
        steps = get_lane_steps(height, width, nl, depth, mode=mode)
        K = sched.num_symbols
        # grid mode: the symbol/word grid has one row per step (padded
        # lattice rasters); dense modes pack K symbols tightly
        rows = steps.num_steps if steps.rows_are_steps else -(-K // nl)
        p = CodecProgram(
            height=height,
            width=width,
            depth=depth,
            nl=nl,
            channels=channels,
            num_tiles=geo.num_tiles,
            num_symbols=K,
            num_steps=steps.num_steps,
            rows=rows,
            n_slots=geo.num_coef_slots,
            mode=mode,
        )
        with _cache_lock:
            _program_cache[key] = p
    return p


def _qdiv_array(qm: np.ndarray, depth: int) -> np.ndarray:
    n = 1 << depth
    layers = np.floor(np.log2(np.arange(n) + 1)).astype(np.int32)
    return np.asarray(qm, dtype=np.int32)[layers]


def _unpack_channels(
    head: np.ndarray, stream: np.ndarray, prog: CodecProgram
):
    """One image's fetched header row + exact-size stream -> container
    fields. Returns (channel_data list, stream u16, est_payload_bytes)."""
    C, nl = prog.channels, prog.nl
    out = []
    est_bits = 0.0
    arr = head[: C * prog.chan_hdr].reshape(C, prog.chan_hdr)
    for c in range(C):
        v = arr[c]
        o = 0
        npar = 6 * prog.num_fine
        vp = v[o : o + npar].view(np.float32).reshape(-1, 6).copy(); o += npar
        wp = v[o : o + npar].view(np.float32).reshape(-1, 6).copy(); o += npar
        bits = v[o : o + CONTEXT_AMOUNT].copy(); o += CONTEXT_AMOUNT
        nmask = CONTEXT_AMOUNT * (ALPHABET_SIZE // 32)
        ompk = v[o : o + nmask].view(np.uint32).reshape(CONTEXT_AMOUNT, -1)
        o += nmask
        scales = v[o : o + CONTEXT_AMOUNT].copy(); o += CONTEXT_AMOUNT
        states = v[o : o + nl].view(np.uint32).copy(); o += nl
        est_bits += float(v[o : o + 1].view(np.float32)[0]); o += 1

        contexts = []
        for b in range(CONTEXT_AMOUNT):
            mask_bits = (
                (ompk[b][:, None] >> np.arange(32, dtype=np.uint32)) & 1
            ).astype(bool).reshape(-1)
            off = np.nonzero(mask_bits)[0].astype(np.uint16)
            # freqs/cdf stay None: the container carries only (bits, off,
            # scale) and every decoder regenerates tables itself
            contexts.append(
                AnsContextTables(
                    max_freq_bits=int(bits[b]),
                    off_distribution_values=off,
                    freqs=None,
                    cdf=None,
                    scale_idx=int(scales[b]),
                )
            )
        out.append(
            ChannelData(
                ans_contexts=contexts,
                lane_states=states,
                value_prediction_parameters=vp,
                width_prediction_parameters=wp,
            )
        )
    return out, stream, est_bits / 8.0


def _encode_dispatch(images: List[RasterImage], opts: EncoderOptions):
    """Upload + launch the fused encode for one same-shape batch; returns
    (prog, device packed output, qm) without blocking on the result."""
    from ..images import ColorSpace
    from .channel_transform import choose_transform

    lossless = opts.quality.name == "LOSSLESS"
    meta = images[0].metadata
    C = meta.num_channels
    for im in images:
        if im.metadata != meta:
            raise ValueError("batch images must share shape and colorspace")
    # The host only RESOLVES the transform policy (strided gradient proxy
    # for "auto"); the transform itself applies inside the fused device
    # program — for a 2048x2048 RGB image the host-side apply + full-image
    # proxy used to cost more than the device encode.
    if meta.colorspace == ColorSpace.RGB:
        transforms = [
            choose_transform(im.data, opts.color_transform, lossless)
            for im in images
        ]
    else:
        transforms = [0] * len(images)
    sched = get_schedule(meta.height, meta.width, mode=opts.mode)
    nl = opts.num_lanes or default_num_lanes(sched.num_symbols)
    prog = get_program(meta.height, meta.width, BASE_FRAC_DEPTH, nl, C, opts.mode)

    qm = quantization_matrix(opts.quality)
    qdiv = jnp.asarray(_qdiv_array(qm, BASE_FRAC_DEPTH))
    # Upload uint8 and cast on device: int32 pixels would quadruple the
    # host->device bytes of a batch. The [B, HW, C] layout keeps every
    # image a zero-copy view of its raster
    # (B == 1 uploads with no host copy at all); the device transposes.
    if len(images) == 1:
        px_host = images[0].data.reshape(1, -1, C)
    else:
        px_host = np.stack([im.data.reshape(-1, C) for im in images])
    pixels = jnp.asarray(px_host)  # [B, HW, C] uint8
    packed, hist = prog.encode_exec(
        pixels,
        qdiv,
        opts.prediction_overrides(C),
        tids=jnp.asarray(np.asarray(transforms, dtype=np.int32)),
    )
    return prog, (packed, hist), qm, (meta, transforms, pixels)


def _encode_finish(prog, packed_dev, qm, meta, opts) -> List[CompressedImage]:
    """Fetch + unpack one batch's packed output into containers.

    Two fetches: the fixed-size headers (with per-image stream totals),
    then a host-sliced prefix of the stream region sized by the largest
    total in the batch — worst-case padding never crosses the link."""
    hist_dev = None
    if isinstance(packed_dev, tuple):
        packed_dev, hist_dev = packed_dev
    transforms = None
    if isinstance(meta, tuple):
        # (meta, transforms[, device_pixels]) — the trailing device
        # pixels ride along for the on-device-verified round trip
        # (roundtrip_pipeline_jax_stream device_verify) and are ignored
        # here; the sharded encoder passes the 2-tuple
        meta, transforms = meta[0], meta[1]
    C = prog.channels
    hw = prog.hdr_words
    # ONE speculative fetch: headers + a learned-size stream prefix.
    # Only when the guess is short (new content regime) does a second
    # exact fetch for the remainder happen; the guess then adapts.
    guess = min(int(getattr(prog, "fetch_guess", 0)), prog.kcp2)
    chunk = np.asarray(packed_dev[:, : hw + guess])
    head = chunk[:, :hw]
    totals = head[:, hw - 1]
    need = (int(totals.max()) + 1) // 2 if totals.size else 0
    if need <= guess:
        tail = chunk[:, hw : hw + need]
    elif need > 0:
        rest = np.asarray(packed_dev[:, hw + guess : hw + need])
        tail = np.concatenate([chunk[:, hw:], rest], axis=1)
    else:
        tail = np.zeros((head.shape[0], 0), dtype=np.int32)
    try:
        prog.fetch_guess = max(guess, min(prog.kcp2, need + need // 4 + 64))
    except AttributeError:
        pass  # duck-typed callers (ShardedEncoder) without the attribute
    from ..metrics import get_metrics

    m = get_metrics()
    m.verbose = m.verbose or getattr(opts, "verbose", False)
    if hist_dev is not None and (
        getattr(opts, "verbose", False)
        or getattr(opts, "emit_coefficients", False)
    ):
        # per-context entropy observability (prediction.rs:209-218 debug
        # metric + :306-313 verbose prints) — extra fetch only on request
        hist_i = np.asarray(hist_dev)  # one host copy
        hist = hist_i.astype(np.float64)
        tot = hist.sum(axis=-1, keepdims=True)
        p = np.where(tot > 0, hist / np.maximum(tot, 1), 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ent = -np.where(p > 0, p * np.log2(p), 0.0).sum(axis=-1)
        for b in range(hist.shape[0]):
            for c in range(C):
                for k in range(hist.shape[2]):
                    if tot[b, c, k, 0] > 0:
                        m.record(
                            f"encode/context_entropy_ch{c}_b{k}",
                            float(ent[b, c, k]),
                        )
                if getattr(opts, "emit_coefficients", False):
                    for k in range(hist.shape[2]):
                        m.record_array(
                            f"encode/context_hist_ch{c}_b{k}",
                            hist_i[b, c, k],
                        )
    out: List[CompressedImage] = []
    for b in range(head.shape[0]):
        total_b = int(totals[b])
        stream_b = tail[b].view(np.uint16)[:total_b].copy()
        m.record(
            "encode/bpp",
            16.0 * total_b / (prog.height * prog.width),
        )
        channel_data, stream_b, est_payload = _unpack_channels(
            head[b], stream_b, prog
        )
        out.append(
            CompressedImage(
                metadata=meta,
                channel_data=list(channel_data) + [None] * (3 - C),
                quality=opts.quality.value,
                num_lanes=prog.nl,
                quantization_matrix=np.asarray(qm, dtype=np.uint16),
                mode=opts.mode,
                stream=stream_b,
                transform=0 if transforms is None else transforms[b],
                est_payload_bytes=est_payload,
            )
        )
    return out


def _maybe_reencode_flat(
    images: List[RasterImage],
    cis: List[CompressedImage],
    opts: EncoderOptions,
) -> List[CompressedImage]:
    """Rate fix for flat/graphic content in ONE statistics pass (ADVICE
    r4): the fused encode already computed each image's exact expected
    code length on device (est_payload_bytes header word, zero extra
    fetch). Where per-lane wire overhead would dominate that payload,
    re-encode just those images at the rate-adaptive lane count through
    the same jax pipeline (pipeline_np applies the identical policy,
    schedule.rate_adaptive_lanes). Natural content never triggers this —
    its payload dwarfs the lane block — so the throughput paths pay only
    this host-side check. Covers batch, stream and (via batch) the
    single-image and trial-transform surfaces."""
    if opts.num_lanes is not None:
        return cis  # caller pinned lanes — nothing to adapt (also the
        # recursion guard for the re-encode below)
    groups: Dict[int, List[int]] = {}
    for i, ci in enumerate(cis):
        est = ci.est_payload_bytes
        if est is None:
            continue
        C = ci.metadata.num_channels
        nl = rate_adaptive_lanes(ci.num_lanes, est, C)
        if nl < ci.num_lanes:
            groups.setdefault(nl, []).append(i)
    for nl, idxs in groups.items():
        o2 = dataclasses.replace(opts, num_lanes=nl)
        redo = encode_pipeline_jax_batch([images[i] for i in idxs], o2)
        for i, ci in zip(idxs, redo):
            cis[i] = ci
    return cis


def encode_pipeline_jax_batch(
    images: List[RasterImage], opts: EncoderOptions
) -> List[CompressedImage]:
    """Encode a batch of SAME-SHAPE images in one device dispatch + fetch."""
    prog, packed_dev, qm, meta = _encode_dispatch(images, opts)
    cis = _encode_finish(prog, packed_dev, qm, meta, opts)
    return _maybe_reencode_flat(images, cis, opts)


def encode_pipeline_jax_stream(
    images: List[RasterImage], opts: EncoderOptions, batch_size: int = 8
) -> List[CompressedImage]:
    """Host/device-pipelined encode over same-shape images (the
    pipeline-parallel analog of SURVEY.md section 2.3: the reference's
    stage machine is strictly sequential, encoder.rs:19-48; here batch
    i+1's device compute overlaps batch i's fetch + host mux via JAX's
    async dispatch — classic double buffering)."""
    from ..profiling import stage_timer

    out: List[CompressedImage] = []
    pending = None  # (prog, packed_dev, qm, meta)
    for i in range(0, len(images), batch_size):
        chunk = images[i : i + batch_size]
        with stage_timer("encode/dispatch"):
            prog, dev, qm, meta = _encode_dispatch(chunk, opts)  # async
        if pending is not None:
            with stage_timer("encode/finish"):
                out.extend(_encode_finish(*pending, opts))
        pending = (prog, dev, qm, meta)
    if pending is not None:
        with stage_timer("encode/finish"):
            out.extend(_encode_finish(*pending, opts))
    return _maybe_reencode_flat(images, out, opts)


def encode_pipeline_jax(image: RasterImage, opts: EncoderOptions) -> CompressedImage:
    return encode_pipeline_jax_batch([image], opts)[0]


def assemble_wire_batch(images: List[CompressedImage], nl: int):
    """Stack a same-shape batch's container fields into the batched wire
    arrays decode_exec consumes: (states, streams, bits, offpk, vparams,
    wparams, qdiv, tids) as numpy arrays (streams zero-padded to a shared
    power-of-two width). Shared by the single-chip batch decode and the
    SPMD ShardedDecoder."""
    meta = images[0].metadata
    C = meta.num_channels
    B = len(images)

    maxw = 1
    for im in images:
        maxw = max(maxw, int(np.asarray(im.stream).shape[0]))
    # pad >= C*nl zero words past the longest stream: decode_step_merged
    # reads each step's word block with one dynamic_slice at gptr, whose
    # window must never clamp against the array end
    Wpad = _next_pow2(max(64, maxw + C * nl))

    sched = get_schedule(meta.height, meta.width, mode=images[0].mode)
    F = sched.num_fine
    bits = np.zeros((B, C, CONTEXT_AMOUNT), dtype=np.int32)
    offpk = np.zeros((B, C, CONTEXT_AMOUNT, ALPHABET_SIZE // 32), dtype=np.uint32)
    # legacy (v<=8) containers select the per-bucket grid row
    scales = np.broadcast_to(
        np.arange(CONTEXT_AMOUNT, dtype=np.int32), (B, C, CONTEXT_AMOUNT)
    ).copy()
    states = np.zeros((B, C, nl), dtype=np.uint32)
    streams = np.zeros((B, Wpad), dtype=np.uint16)
    vparams = np.zeros((B, C, F, 6), dtype=np.float32)
    wparams = np.zeros((B, C, F, 6), dtype=np.float32)

    for b, im in enumerate(images):
        st = np.asarray(im.stream, dtype=np.uint16)
        streams[b, : st.shape[0]] = st
        for c in range(C):
            cd = im.channel_data[c]
            for k, t in enumerate(cd.ans_contexts):
                bits[b, c, k] = t.max_freq_bits
                if t.scale_idx >= 0:
                    scales[b, c, k] = t.scale_idx
                off = np.asarray(t.off_distribution_values, dtype=np.int64)
                if off.size:
                    np.bitwise_or.at(
                        offpk[b, c, k],
                        off // 32,
                        np.uint32(1) << (off % 32).astype(np.uint32),
                    )
            states[b, c] = np.asarray(cd.lane_states, dtype=np.uint32)
            # v7 containers carry 3 coarse rows; expand to the fine ids
            vparams[b, c] = sched.expand_params(
                cd.value_prediction_parameters
            )
            wparams[b, c] = sched.expand_params(
                cd.width_prediction_parameters
            )

    # Per-image dequantization tables: a same-shape batch may mix quality
    # levels (stream chunking / ShardedDecoder hand in arbitrary lists).
    qdiv = np.stack(
        [
            _qdiv_array(
                np.asarray(im.quantization_matrix, dtype=np.int32),
                BASE_FRAC_DEPTH,
            )
            for im in images
        ]
    )
    tids = np.asarray([im.transform for im in images], dtype=np.int32)
    return states, streams, bits, offpk, scales, vparams, wparams, qdiv, tids


def decode_pipeline_jax_batch(
    images: List[CompressedImage], _defer: bool = False
) -> List[RasterImage]:
    """Decode a batch of SAME-SHAPE compressed images in one dispatch.
    _defer=True returns the un-fetched device pixels (stream pipelining)."""
    meta = images[0].metadata
    C = meta.num_channels
    nl = images[0].num_lanes
    mode = images[0].mode
    for im in images:
        if im.metadata != meta or im.num_lanes != nl or im.mode != mode:
            raise ValueError("batch must share shape, colorspace, lanes and mode")
    prog = get_program(meta.height, meta.width, BASE_FRAC_DEPTH, nl, C, mode)

    (
        states, streams, bits, offpk, scales, vparams, wparams, qdiv, tids
    ) = assemble_wire_batch(images, nl)

    lut_bits = pick_lut_bits(bits)
    pixels_dev = prog.decode_exec(
        jnp.asarray(states),
        jnp.asarray(streams),
        jnp.asarray(bits),
        jnp.asarray(offpk),
        jnp.asarray(scales),
        jnp.asarray(vparams),
        jnp.asarray(wparams),
        jnp.asarray(qdiv),
        jnp.asarray(tids),
        lut_bits,
    )  # async launch; np.asarray below is the ONE fetch
    if _defer:
        return pixels_dev, meta, C
    return _decode_finish(pixels_dev, meta, C)


def decode_pipeline_jax_stream(
    images: List[CompressedImage], batch_size: int = 8
) -> List[RasterImage]:
    """Host/device-pipelined decode (double buffering, see
    encode_pipeline_jax_stream)."""
    from ..profiling import stage_timer

    out: List[RasterImage] = []
    pending = None  # (pixels_dev, meta, C)
    for i in range(0, len(images), batch_size):
        chunk = images[i : i + batch_size]
        with stage_timer("decode/dispatch"):
            dev, meta, C = decode_pipeline_jax_batch(chunk, _defer=True)
        if pending is not None:
            with stage_timer("decode/finish"):
                out.extend(_decode_finish(*pending))
        pending = (dev, meta, C)
    if pending is not None:
        with stage_timer("decode/finish"):
            out.extend(_decode_finish(*pending))
    return out


def _decode_finish(pixels_dev, meta, C) -> List[RasterImage]:
    """Fetch [B, C, HW] device pixels (already inverse-channel-transformed
    on device) and wrap them as RasterImages — transpose-only on host."""
    pixels = np.asarray(pixels_dev)
    return [
        RasterImage(
            metadata=meta,
            data=pixels[b].T.reshape(meta.height, meta.width, C),
        )
        for b in range(pixels.shape[0])
    ]


def decode_pipeline_jax(image: CompressedImage) -> RasterImage:
    return decode_pipeline_jax_batch([image])[0]


_verify_jit = None


def _device_verify_batch(pixels_dev, px_in):
    """Compare decoded [B, C, HW] pixels against the encode upload
    [B, HW, C] ON DEVICE; returns the mismatch-count DeviceArray (one
    scalar fetch instead of the full pixel downlink — VERDICT r4 #4:
    the input pixels are already resident, so bench-mode losslessness
    needs no decoded-pixel fetch)."""
    global _verify_jit
    if _verify_jit is None:
        import jax

        _verify_jit = jax.jit(
            lambda dec, src: jnp.sum(
                (dec != jnp.transpose(src, (0, 2, 1))).astype(jnp.int32)
            )
        )
    return _verify_jit(pixels_dev, px_in)


def roundtrip_pipeline_jax_stream(
    images: List[RasterImage],
    opts: EncoderOptions,
    batch_size: int = 8,
    device_verify: bool = False,
) -> Tuple[List[bytes], List[RasterImage]]:
    """Software-pipelined encode -> container bytes -> decode over a
    same-shape corpus; returns (blobs, decoded images).

    Keeps the device busy with back-to-back compute (enc_i, then
    dec_{i-1}, enqueued in that order) while every device->host fetch
    and all host mux (container build, serialize/deserialize) ride the
    other stage's compute window, where the separate encode-then-decode
    streams leave the device idle during every fetch of their own stage.
    Whether the device's idle share on a GPU still justifies this
    pipelining is an open measurement.

    The full corpus round trip (bench.rs:70-104 is the reference's
    serial equivalent) is the de-facto integration test and the metric
    configuration of BASELINE.json.

    Fetches run on worker threads: a device->host fetch blocks the
    calling thread for latency + bytes/bandwidth, and
    issuing it from the main thread serializes it with the next batch's
    dispatch. Workers block inside np.asarray while the main thread
    keeps enqueuing device compute (PJRT is thread-safe); the main
    thread only ever blocks on an already-fetching future.

    device_verify=True (bench mode, VERDICT r4 #4): decoded pixels are
    verified against the encode-side device pixels ON DEVICE and never
    fetched — each batch's downlink shrinks to one mismatch-count
    scalar. Returns (blobs, total_mismatch_count: int) instead of
    (blobs, decoded images)."""
    from concurrent.futures import ThreadPoolExecutor

    from .container import deserialize, serialize

    blobs: List[bytes] = []
    outs: List[RasterImage] = []
    mismatches = 0

    def enc_finish(enc):
        cis = _encode_finish(*enc, opts)  # blocks worker on the fetch
        bl = [serialize(ci) for ci in cis]
        return bl, [deserialize(b) for b in bl], enc[3][2]

    def fetch_mismatch(m_dev):
        return int(np.asarray(m_dev))

    enc_fut = None  # fetching containers of batch i-1
    dec_fut = None  # fetching decoded pixels of batch i-2
    with ThreadPoolExecutor(max_workers=2) as pool:
        def launch_decode(cis, px_in):
            dev, meta, C = decode_pipeline_jax_batch(cis, _defer=True)
            if device_verify:
                m = _device_verify_batch(dev, px_in)
                return pool.submit(fetch_mismatch, m)
            return pool.submit(_decode_finish, dev, meta, C)

        for i in range(0, len(images), batch_size):
            chunk = images[i : i + batch_size]
            enc = _encode_dispatch(chunk, opts)  # device: enc_i
            if enc_fut is not None:
                bl, cis, px_in = enc_fut.result()
                blobs.extend(bl)
                new_dec = launch_decode(cis, px_in)  # device: dec_{i-1}
            else:
                new_dec = None
            if dec_fut is not None:
                if device_verify:
                    mismatches += dec_fut.result()
                else:
                    outs.extend(dec_fut.result())
            dec_fut = new_dec
            enc_fut = pool.submit(enc_finish, enc)
        # drain: last encode -> last decode
        if enc_fut is not None:
            bl, cis, px_in = enc_fut.result()
            blobs.extend(bl)
            last = launch_decode(cis, px_in)
            for fut in (dec_fut, last):
                if fut is None:
                    continue
                if device_verify:
                    mismatches += fut.result()
                else:
                    outs.extend(fut.result())
        elif dec_fut is not None:
            if device_verify:
                mismatches += dec_fut.result()
            else:
                outs.extend(dec_fut.result())
    if device_verify:
        return blobs, mismatches
    return blobs, outs
