"""Context frequency tables: Laplace-parametric fill + integer renormalization.

Capability-parity with the reference's table pipeline (entropy_coding.rs:
82-159): both the encoder and the decoder regenerate the tables from only
(max_freq_bits, off_distribution_values) (serialize.rs:93-105, 230-236)
and must agree bit-for-bit. Everything here is branch-light vectorized
integer math with an *identical device twin* (frave_tpu/entropy/
tables_jax.py) so the encoder can finalize tables on-device inside the
fused encode program — the pair is property-tested for exact equality.

Determinism hardening vs the reference: the reference computes the Laplace
pmf with f32 libm exp at runtime (prediction.rs:220-222); a 1-ulp libm
difference between the encode and decode host would corrupt the tables.
Here exp(-|x|/width) is computed as r^|x| by exponentiation-by-squaring in
IEEE f64 from hardcoded hex-float constants — bit-identical on every
platform (and precomputed on host, so the device never needs f64).

Documented divergences from the reference (SURVEY.md section 7 "bugs to
consciously not replicate"):
  * empty-context max_freq_bits: reference computes trailing_zeros(0)=64
    and would panic on 1<<64 (entropy_coding.rs:113-114); we clamp to 8.
  * normalization: the reference renormalizes with a sequential
    zero-frequency stealing loop (entropy_coding.rs:119-159) whose final
    symbol wraps in u32 (:157). We use largest-remainder normalization
    with a deterministic largest-donor fixup — same guarantees (sum is
    exactly 1 << bits, every data symbol keeps freq >= 1), but expressible
    as fixed-shape vector ops on both host and device.
  * max_freq_bits is capped at 14 (vs unbounded in the 64-bit-rANS
    reference) so the 32-bit-state/16-bit-renorm vectorized lanes keep the
    at-most-one-renorm-per-symbol invariant (frave_tpu/ops/rans.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

ALPHABET_SIZE = 1024  # zig-zag residual symbols (entropy_coding.rs:25)
# Laplace-width buckets. The reference uses 10 buckets with the narrowest
# at width 2.5 (prediction.rs:15,70-84) — that floors the rate at ~3.3
# bits/symbol even on perfectly predicted (all-zero-residual) content.
# Narrow buckets (0.1, 0.4, 1.0, 1.8) are added so flat regions approach
# their true entropy (bucket 0 at width 0.1 is effectively a
# zero-residual context: its Laplace pmf rounds to a delta at symbol 0,
# outliers ride the off-list); the bucket edges are compared in f32
# instead of the reference's `width as u32` truncation so sub-integer
# widths resolve, and a deterministic flat-context rule
# (ops/prediction.py: all gradient features zero -> bucket 0) routes
# perfectly-predicted symbols there regardless of the learned width
# model's bias floor.
CONTEXT_AMOUNT = 15
MIN_FREQ_BITS = 8
MAX_FREQ_BITS_CAP = 14
NUM_BITS_CHOICES = MAX_FREQ_BITS_CAP - MIN_FREQ_BITS + 1  # 7
# Encoder-side cap, below the wire/decoder max: the decode LUT's size is
# 2^bits per context, so every additional bit doubles the per-batch
# table footprint and its per-call construction cost, while the rate
# cost of 12-vs-14-bit probability resolution is +0.03% (synthetic
# probe, round 2). Decoders must keep accepting up to
# MAX_FREQ_BITS_CAP — v7/v8 streams on the wire carry 13/14-bit contexts.
ENC_FREQ_BITS_CAP = 12

# (exp(-1/width), 1/(2*width)) as IEEE-754 f64 hex literals per bucket
# width. Hardcoded for cross-platform determinism (see module docstring).
_LAPLACE_CONSTANTS: Tuple[Tuple[str, str], ...] = (
    ("0x1.7cd79b5647c9bp-15", "0x1.4000000000000p+2"),  # width 0.1
    ("0x1.50385c094f425p-4", "0x1.4000000000000p+0"),  # width 0.4
    ("0x1.78b56362cef38p-2", "0x1.0000000000000p-1"),  # width 1.0
    ("0x1.25c3022412203p-1", "0x1.1c71c71c71c72p-2"),  # width 1.8
    ("0x1.57343067270eep-1", "0x1.999999999999ap-3"),  # width 2.5
    ("0x1.99fa40bc6c5f7p-1", "0x1.c71c71c71c71cp-4"),  # width 4.5
    ("0x1.b4da1cb5e42a6p-1", "0x1.4514514514514p-4"),  # width 6.3
    ("0x1.c72c49b875881p-1", "0x1.e1e1e1e1e1e1ep-5"),  # width 8.5
    ("0x1.d93b3c706d012p-1", "0x1.42850a142850ap-5"),  # width 12.7
    ("0x1.e0fabfbc702a4p-1", "0x1.0000000000000p-5"),  # width 16.0
    ("0x1.e7078b0a726a6p-1", "0x1.999999999999ap-6"),  # width 20.0
    ("0x1.eb1ae169e74aep-1", "0x1.5555555555555p-6"),  # width 24.0
    ("0x1.ee097670efc30p-1", "0x1.2492492492492p-6"),  # width 28.0
    ("0x1.f1f936ca50d7dp-1", "0x1.c71c71c71c71cp-7"),  # width 36.0
    ("0x1.f5dc99badec5bp-1", "0x1.47ae147ae147bp-7"),  # width 50.0
)

_BUCKET_WIDTHS = (
    0.1, 0.4, 1.0, 1.8, 2.5, 4.5, 6.3, 8.5, 12.7, 16.0, 20.0, 24.0, 28.0, 36.0,
    50.0,
)

# --- format v9: per-image Laplace-scale selection -------------------------
# The reference codes every context with a FIXED Laplace scale per bucket
# (prediction.rs:70-84 widths; entropy_coding.rs:82-96 fill) — only the
# support (off-list) and scale_bits adapt per image. On real photographs
# the fixed scales mismatch the residual statistics by enough to cost
# 0.7-2.4% (flat graphics: 17%; rate measured in round 2). v9
# adds a per-(channel, context) scale index into a fixed GRID of
# precomputed Laplace rows: the encoder picks the scale minimizing the
# estimated code length of the context's actual histogram, the index
# travels in the container EHD, and the decoder regenerates the same u32
# rows — the cross-platform determinism story is unchanged because every
# grid row is precomputed from hex-pinned f64 constants exactly like the
# legacy per-bucket rows (which are grid rows 0..14).
_EXTRA_SCALE_WIDTHS = (
    0.05, 0.2, 0.3, 0.55, 0.7, 0.85, 1.2, 1.4, 2.1, 3.0, 3.6, 5.4,
    7.3, 9.8, 11.0, 14.0, 18.0, 22.0, 26.0, 31.0, 42.0, 58.0, 68.0,
    80.0, 95.0, 110.0, 130.0, 155.0, 185.0, 220.0, 260.0, 310.0, 370.0,
)
_EXTRA_SCALE_CONSTANTS: Tuple[Tuple[str, str], ...] = (
    ("0x1.1b48655f37267p-29", "0x1.4000000000000p+3"),  # width 0.05
    ("0x1.b993fe00d5376p-8", "0x1.4000000000000p+1"),  # width 0.2
    ("0x1.243dc957d03eep-5", "0x1.aaaaaaaaaaaabp+0"),  # width 0.3
    ("0x1.4c6ebfa3f1315p-3", "0x1.d1745d1745d17p-1"),  # width 0.55
    ("0x1.eace299fc26b5p-3", "0x1.6db6db6db6db7p-1"),  # width 0.7
    ("0x1.3bc4141d5d8f2p-2", "0x1.2d2d2d2d2d2d3p-1"),  # width 0.85
    ("0x1.bd075011c09aap-2", "0x1.aaaaaaaaaaaabp-2"),  # width 1.2
    ("0x1.f54a68a74e851p-2", "0x1.6db6db6db6db7p-2"),  # width 1.4
    ("0x1.3e06bcf40de3fp-1", "0x1.e79e79e79e79ep-3"),  # width 2.1
    ("0x1.6edd3122f2ea5p-1", "0x1.5555555555555p-3"),  # width 3.0
    ("0x1.83d27824a69c6p-1", "0x1.1c71c71c71c72p-3"),  # width 3.6
    ("0x1.a972545a72f16p-1", "0x1.7b425ed097b42p-4"),  # width 5.4
    ("0x1.be7472766119fp-1", "0x1.188c46231188cp-4"),  # width 7.3
    ("0x1.ce550ef321f26p-1", "0x1.a1f58d0fac687p-5"),  # width 9.8
    ("0x1.d381efe4c5e23p-1", "0x1.745d1745d1746p-5"),  # width 11.0
    ("0x1.dcb442bab408ep-1", "0x1.2492492492492p-5"),  # width 14.0
    ("0x1.e454ccac9798ap-1", "0x1.c71c71c71c71cp-6"),  # width 18.0
    ("0x1.e93f8eec13d61p-1", "0x1.745d1745d1746p-6"),  # width 22.0
    ("0x1.ecae7c244eed7p-1", "0x1.3b13b13b13b14p-6"),  # width 26.0
    ("0x1.efbf56d4eef6cp-1", "0x1.0842108421084p-6"),  # width 31.0
    ("0x1.f3f418cf485e5p-1", "0x1.8618618618618p-7"),  # width 42.0
    ("0x1.f73f820d7ff4dp-1", "0x1.1a7b9611a7b96p-7"),  # width 58.0
    ("0x1.f886930a6b94bp-1", "0x1.e1e1e1e1e1e1ep-8"),  # width 68.0
    ("0x1.f9a3cc26c0f05p-1", "0x1.999999999999ap-8"),  # width 80.0
    ("0x1.faa387eb19635p-1", "0x1.58ed2308158edp-8"),  # width 95.0
    ("0x1.fb5dd6105171fp-1", "0x1.29e4129e4129ep-8"),  # width 110.0
    ("0x1.fc139f2dbf8c3p-1", "0x1.f81f81f81f820p-9"),  # width 130.0
    ("0x1.fcb5189e10c9dp-1", "0x1.a6d01a6d01a6dp-9"),  # width 155.0
    ("0x1.fd3d6a036c375p-1", "0x1.623fa77016240p-9"),  # width 185.0
    ("0x1.fdad91f774fcep-1", "0x1.29e4129e4129ep-9"),  # width 220.0
    ("0x1.fe08d85bac4d0p-1", "0x1.f81f81f81f820p-10"),  # width 260.0
    ("0x1.fe59de4a3e7a5p-1", "0x1.a6d01a6d01a6dp-10"),  # width 310.0
    ("0x1.fe9e3ac957f18p-1", "0x1.623fa77016240p-10"),  # width 370.0
)
# grid rows 0..CONTEXT_AMOUNT-1 are EXACTLY the legacy per-bucket rows, so
# a scale index equal to the bucket id reproduces v7/v8 behavior.
GRID_WIDTHS = _BUCKET_WIDTHS + _EXTRA_SCALE_WIDTHS
_GRID_CONSTANTS = _LAPLACE_CONSTANTS + _EXTRA_SCALE_CONSTANTS
NUM_SCALES = len(GRID_WIDTHS)

# bucket b covers widths in [BUCKET_EDGES[b-1], BUCKET_EDGES[b]); edges
# beyond 3.0 keep the reference's integer boundaries (prediction.rs:55-68).
BUCKET_EDGES = (
    0.25, 0.6, 1.4, 2.2, 3.0, 5.0, 6.0, 8.0, 12.0, 16.0, 20.0, 25.0, 30.0, 42.0,
)


def width_of_bucket(bucket: int) -> float:
    """Representative Laplace width per bucket."""
    return _BUCKET_WIDTHS[min(bucket, CONTEXT_AMOUNT - 1)]


def assign_bucket(width) -> np.ndarray:
    """Width -> bucket: count of edges <= width, in f32 (NaN/negative -> 0).

    Must match the device twin (frave_tpu/ops/jax_ops.assign_bucket_f32)
    exactly: same f32 edge comparisons."""
    w = np.asarray(width, dtype=np.float32)
    w = np.where(np.isnan(w), np.float32(0), np.maximum(w, np.float32(0)))
    edges = np.asarray(BUCKET_EDGES, dtype=np.float32)
    bucket = np.zeros(w.shape, dtype=np.int32)
    for e in edges:
        bucket = bucket + (w >= e).astype(np.int32)
    return bucket


def _laplace_rows_all() -> np.ndarray:
    """[NUM_SCALES, NUM_BITS_CHOICES, 1024] u32:
    trunc(laplace(x_j; 0, width_g) * 2**bits) for every (grid scale, bits).
    Rows 0..CONTEXT_AMOUNT-1 are the legacy per-bucket rows.

    r^|x| via vectorized square-and-multiply in f64 — the multiply order
    (ascending bit index) matches a scalar exponentiation-by-squaring
    loop, so results are IEEE-deterministic across platforms.
    """
    j = np.arange(ALPHABET_SIZE, dtype=np.int64)
    ax = (j + 1) // 2  # |unpack_signed(j)|
    out = np.zeros((NUM_SCALES, NUM_BITS_CHOICES, ALPHABET_SIZE), dtype=np.uint32)
    for g in range(NUM_SCALES):
        r = float.fromhex(_GRID_CONSTANTS[g][0])
        s = float.fromhex(_GRID_CONSTANTS[g][1])
        acc = np.ones(ALPHABET_SIZE, dtype=np.float64)
        base = r
        e = ax.copy()
        for _ in range(10):  # ax < 2**10
            acc = np.where(e & 1 == 1, acc * base, acc)
            base = base * base
            e >>= 1
        for bi in range(NUM_BITS_CHOICES):
            scale = float(1 << (MIN_FREQ_BITS + bi))
            out[g, bi] = (acc * s * scale).astype(np.uint32)  # trunc; v >= 0
    return out


_LAPLACE_GRID_ROWS: np.ndarray = _laplace_rows_all()  # [NUM_SCALES, 7, 1024]
# legacy per-bucket view (grid rows 0..CONTEXT_AMOUNT-1 == bucket rows)
_LAPLACE_ROWS: np.ndarray = _LAPLACE_GRID_ROWS[:CONTEXT_AMOUNT]
# log2(max(row, 1)) per grid row, for code-length scale selection (the
# same proxy the device twin uses; f32 like the device einsum inputs)
_GRID_LOG2: np.ndarray = np.log2(
    np.maximum(_LAPLACE_GRID_ROWS.astype(np.float64), 1.0)
).astype(np.float32)


def laplace_freqs(bucket: int, max_freq_bits: int) -> np.ndarray:
    return _LAPLACE_ROWS[bucket, max_freq_bits - MIN_FREQ_BITS].copy()


def select_scale(hist: np.ndarray, bits: int) -> int:
    """Pick the grid scale minimizing the estimated code length of `hist`
    at `bits` of frequency resolution: cost(g) = sum_j hist[j] *
    (bits - log2(max(row_g[j], 1))) + 16 * |{data symbols row_g zeroes}|.
    Symbols the row zeroes are coded at freq 1 (the max(.,1) clamp) AND
    cost 2 off-list wire bytes each — without that term wide scales at
    low bits (mostly-zero rows) win on pure code length while bloating
    the off-list. Since sum(hist)*bits is constant across g, minimizing
    cost = maximizing sum_j hist*log2row - 16*zeroed_data. Ties resolve
    to the lowest index.

    Selection is encode-only — the chosen index travels on the wire, so
    host/device selections need not agree bit-for-bit (and don't: the
    device twin contracts its sums in another order)."""
    b = int(np.clip(bits, MIN_FREQ_BITS, MAX_FREQ_BITS_CAP)) - MIN_FREQ_BITS
    hf = hist.astype(np.float32)
    data = (hist > 0).astype(np.float32)
    zero_rows = (_LAPLACE_GRID_ROWS[:, b] == 0).astype(np.float32)
    gains = _GRID_LOG2[:, b] @ hf - np.float32(16.0) * (zero_rows @ data)
    return int(np.argmax(gains))


@dataclasses.dataclass
class ContextTables:
    """Finalized rANS tables for one bucket context."""

    max_freq_bits: int
    off_distribution_values: np.ndarray  # [m] uint16, ascending
    freqs: np.ndarray  # [1024] uint32, sums to 1 << max_freq_bits
    cdf: np.ndarray  # [1024] uint32 exclusive prefix sums
    scale_idx: int = -1  # grid row (v9); -1 = legacy (row == bucket id)


def _fill_with_laplace(
    hist: np.ndarray, scale: int, bits: int, off_mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """entropy_coding.rs:82-96 vectorized. hist: [1024] data histogram
    (zeros on the decode side); off_mask: [1024] bool wire off-list;
    scale: grid row (legacy callers pass the bucket id — grid rows
    0..CONTEXT_AMOUNT-1 are the per-bucket rows).
    Returns (filled [1024] i64, off_mask_out [1024] bool)."""
    lap = _LAPLACE_GRID_ROWS[scale, bits - MIN_FREQ_BITS].astype(np.int64)
    data = hist.astype(np.int64) > 0
    forced = (lap == 0) & (data | off_mask)
    filled = np.where(forced, 1, lap)
    off_out = off_mask | ((lap == 0) & data)
    return filled, off_out


def _normalize_freqs(filled: np.ndarray, target_total: int) -> Tuple[np.ndarray, np.ndarray]:
    """Largest-remainder normalization with deterministic largest-donor
    fixup. Guarantees: sum(freqs) == target_total exactly; freqs[j] >= 1
    wherever filled[j] > 0 (requires target_total >= nnz(filled)).
    Returns (freqs u32, exclusive-cdf u32)."""
    f = filled.astype(np.int64)
    total = int(f.sum())
    if total == 0:
        raise ValueError("cannot normalize an all-zero frequency table")
    target = int(target_total)
    scaled = (f * target) // total
    s = np.where(f > 0, np.maximum(scaled, 1), 0)
    diff = target - int(s.sum())
    if diff > 0:
        j = int(np.argmax(s))
        s[j] += diff
    else:
        while diff < 0:
            j = int(np.argmax(s))
            take = min(-diff, int(s[j]) - 1)
            if take <= 0:
                raise ValueError("target_total too small for symbol count")
            s[j] -= take
            diff += take
    freqs = s.astype(np.uint32)
    cdf = np.zeros(ALPHABET_SIZE, dtype=np.uint32)
    np.cumsum(freqs[:-1], out=cdf[1:].view(np.uint32))
    return freqs, cdf


def _mask_from_off_list(off_list: Sequence[int]) -> np.ndarray:
    m = np.zeros(ALPHABET_SIZE, dtype=bool)
    idx = np.asarray(list(off_list), dtype=np.int64)
    if idx.size:
        if int(idx.min()) < 0 or int(idx.max()) >= ALPHABET_SIZE:
            raise ValueError("off-distribution value outside the alphabet")
        m[idx] = True
    return m


def finalize_context(
    hist: np.ndarray,
    bucket: int,
    max_freq_bits: int,
    off_list: Sequence[int] = (),
    scale_idx: int = -1,
) -> ContextTables:
    """finalize_context (entropy_coding.rs:102-117): clamp bits, Laplace
    fill, renormalize to 1 << bits. `hist` is the raw residual histogram on
    the encode side and all-zeros on the decode side. `scale_idx` picks
    the Laplace grid row (v9); -1 means the legacy per-bucket row.

    If the filled table has more nonzero symbols than 1 << bits (wide
    residual spreads, e.g. noise images), bits is bumped until every data
    symbol can keep a nonzero normalized frequency (the reference would
    produce zero-frequency encode symbols and panic inside the rans
    crate). The bumped value travels on the wire, so decode regenerates
    identically."""
    bits = max(MIN_FREQ_BITS, min(int(max_freq_bits), MAX_FREQ_BITS_CAP))
    scale = bucket if scale_idx < 0 else int(scale_idx)
    if scale >= NUM_SCALES:
        raise ValueError(f"scale index {scale} outside the grid")
    off_mask = _mask_from_off_list(off_list)
    while True:
        filled, off_out = _fill_with_laplace(hist, scale, bits, off_mask)
        nnz = int(np.count_nonzero(filled))
        if (1 << bits) >= nnz or bits >= MAX_FREQ_BITS_CAP:
            break
        bits += 1
    freqs, cdf = _normalize_freqs(filled, 1 << bits)
    return ContextTables(
        max_freq_bits=bits,
        off_distribution_values=np.nonzero(off_out)[0].astype(np.uint16),
        freqs=freqs,
        cdf=cdf,
        scale_idx=scale,
    )


def context_from_histogram(
    hist: np.ndarray, bucket: int, adaptive_scale: bool = True
) -> ContextTables:
    """Encoder-side: bits from the histogram total (prediction.rs:302-305),
    clamped to [MIN_FREQ_BITS, MAX_FREQ_BITS_CAP]; v9 additionally picks
    the best-fitting Laplace grid scale for this image's histogram."""
    total = int(hist.sum())
    bits = int(total).bit_length() - 1 if total > 0 else MIN_FREQ_BITS
    # The bump loop never exceeds this cap: nnz <= ALPHABET_SIZE = 1024
    # <= 2^ENC_FREQ_BITS_CAP, so every data symbol keeps freq >= 1.
    bits = min(bits, ENC_FREQ_BITS_CAP)
    scale = select_scale(hist, bits) if (adaptive_scale and total > 0) else bucket
    return finalize_context(hist, bucket, bits, scale_idx=scale)


def context_from_wire(
    bucket: int,
    max_freq_bits: int,
    off_list: Sequence[int],
    scale_idx: int = -1,
) -> ContextTables:
    """Decoder-side regeneration from the wire fields only
    (serialize.rs:230-236); v9 wires additionally carry the scale index."""
    zeros = np.zeros(ALPHABET_SIZE, dtype=np.uint32)
    return finalize_context(zeros, bucket, max_freq_bits, off_list, scale_idx)
