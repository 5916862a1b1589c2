"""Interleaved-lane rANS as JAX scans (device compute path).

Same wire semantics as the numpy host coder (frave_tpu/ops/rans.py): 32-bit
state per lane, 16-bit renorm words, state domain [2^16, 2^32), per-context
scale_bits <= 14 so each symbol moves at most one word in either direction.
The data-parallel redesign of the reference's per-symbol serial coder
(entropy_coding.rs:266-352):

  * Encode is a `lax.scan` in reverse schedule order over the [R, NL]
    symbol grid; every step advances all NL lanes (x C channels) at once
    and emits at most one u16 word per lane plus an emit flag. The host
    compacts flagged words into per-lane streams (variable-length output
    is the one thing XLA cannot shape — SURVEY.md section 7 phase 2).
  * Decode is a `lax.scan` over wavefront steps: contexts for a whole step
    are computable from already-decoded coefficients (SURVEY.md section
    3.2), so each step decodes one symbol per active lane across all
    channels. cdf -> symbol uses ONE on-device merged
    [CONTEXT_AMOUNT, 2^lut_bits, 2] (sym, freq, cdf) table
    (build_merged_decode_table) instead of the reference's binary search
    + linear walk (entropy_coding.rs:180-185,246-255) — semantics
    identical: the entry holds the *last* symbol whose cdf <= slot.

All arithmetic stays in uint32: overflow-free by the rANS invariants
(renorm guarantees x < freq << (32 - bits) before the encode step, and the
decode product freq * (x >> bits) is bounded by the encoder's pre-state).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..entropy.tables import CONTEXT_AMOUNT

RANS_L = 1 << 16
WORD_BITS = 16
LUT_BITS = 14  # == MAX_FREQ_BITS_CAP (frave_tpu/entropy/tables.py)

# lax.scan unroll factor for both rANS scans. On the hardware this was
# first tuned on, unrolling hurt both scans (the per-step cost was the
# batched-index gathers, not loop-trip overhead, so unrolling only grew
# the program). Default stays 1 until a GPU trace re-decides it.
SCAN_UNROLL = int(os.environ.get("FRAVE_SCAN_UNROLL", "1"))


def encode_scan(
    sym_grid: jnp.ndarray,  # [R, ..., NL] int32 zig-zag symbols (schedule order)
    bkt_grid: jnp.ndarray,  # [R, ..., NL] int32 context buckets
    valid_grid: jnp.ndarray,  # [R, ..., NL] bool
    freqs: jnp.ndarray,  # [..., CA, 1024] uint32
    cdfs: jnp.ndarray,  # [..., CA, 1024] uint32
    scale_bits: jnp.ndarray,  # [..., CA] int32
):
    """Vectorized reverse-scan rANS encode.

    Leading `...` dims (e.g. channels) are batched via vmap inside the scan
    body. Returns (final_states [..., NL] uint32,
    words [R, ..., NL] uint16, flags [R, ..., NL] bool): words[r] is valid
    where flags[r]; decode consumes flagged words in increasing r.
    """
    lanes_shape = sym_grid.shape[1:]
    R = sym_grid.shape[0]
    ca = CONTEXT_AMOUNT
    x0 = jnp.full(lanes_shape, RANS_L, dtype=jnp.uint32)

    # Per-symbol (freq, cdf, bits) via IN-SCAN one-hot window selection
    # instead of a bulk [R, ..., NL] table gather: that gather was the
    # single hottest op of the whole encode in a round-2 device profile,
    # while the bf16 one-hot contractions cost little. The
    # per-(bucket, sym>>5) window of 33
    # *overlapping* cdf entries (entry 1024 = 2**bits sentinel) yields
    # cdf[s] and freq[s] = cdf[s+1] - cdf[s] — exact for every coded
    # symbol, whose freq is nonzero by construction. bf16 exactness: see
    # prepare_compare_tables.
    cdf_ext = jnp.concatenate(
        [
            cdfs.astype(jnp.int32),
            (jnp.int32(1) << scale_bits.astype(jnp.int32))[..., None],
        ],
        axis=-1,
    )  # [..., CA, 1025]
    # overlapping windows win[..., k, j, a] = cdf_ext[..., k, 32j + a],
    # a in [0, 33) — built from 32 static slices (contiguous copies, no
    # gather)
    win = jnp.stack(
        [cdf_ext[..., W32 * j : W32 * j + W32 + 1] for j in range(W32)],
        axis=-2,
    )
    win_hi = (win >> 7).astype(jnp.bfloat16)  # [..., CA, 32, 33]
    win_lo = (win & 127).astype(jnp.bfloat16)
    nW = ca * W32
    win_hi2 = win_hi.reshape(cdfs.shape[:-2] + (nW, W32 + 1))
    win_lo2 = win_lo.reshape(cdfs.shape[:-2] + (nW, W32 + 1))
    bits_bf = scale_bits.astype(jnp.bfloat16)  # [..., CA]

    sym_f = jnp.clip(sym_grid, 0, 1023).astype(jnp.int32)
    bkt_f = jnp.clip(bkt_grid, 0, ca - 1).astype(jnp.int32)

    iota_w = jnp.arange(nW, dtype=jnp.int32)
    iota_ca = jnp.arange(ca, dtype=jnp.int32)
    iota_lo = jnp.arange(W32 + 1, dtype=jnp.int32)

    def step(x, row):
        sym, bkt, valid = row
        combo = bkt * W32 + (sym >> 5)  # [..., NL]
        ohc = jnp.asarray(
            combo[..., None] == iota_w, dtype=jnp.bfloat16
        )  # [..., NL, CA*32]
        ohb = jnp.asarray(
            bkt[..., None] == iota_ca, dtype=jnp.bfloat16
        )
        sym_lo = sym & 31
        oh_lo = jnp.asarray(
            sym_lo[..., None] == iota_lo, dtype=jnp.bfloat16
        )  # [..., NL, 33]
        oh_lo1 = jnp.asarray(
            (sym_lo + 1)[..., None] == iota_lo, dtype=jnp.bfloat16
        )
        cdw = (
            jnp.einsum(
                "...nw,...wa->...na", ohc, win_hi2,
                preferred_element_type=jnp.float32,
            )
            * 128.0
            + jnp.einsum(
                "...nw,...wa->...na", ohc, win_lo2,
                preferred_element_type=jnp.float32,
            )
        )  # [..., NL, 33] f32 exact (<= 2**14)
        cd_f = jnp.einsum(
            "...na,...na->...n", cdw, oh_lo.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        )
        nx_f = jnp.einsum(
            "...na,...na->...n", cdw, oh_lo1.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        )
        bi_f = jnp.einsum(
            "...nk,...k->...n", ohb, bits_bf,
            preferred_element_type=jnp.float32,
        )
        cd = jnp.where(valid, cd_f.astype(jnp.uint32), jnp.uint32(0))
        fr = jnp.where(
            valid, (nx_f - cd_f).astype(jnp.uint32), jnp.uint32(1)
        )
        bi = jnp.where(valid, bi_f.astype(jnp.uint32), jnp.uint32(8))
        # renorm: emit low 16 bits iff x >= fr << (32 - bi), computed
        # overflow-free as (x >> (32 - bi)) >= fr
        emit = valid & ((x >> (jnp.uint32(32) - bi)) >= fr)
        word = (x & jnp.uint32(0xFFFF)).astype(jnp.uint16)
        x1 = jnp.where(emit, x >> jnp.uint32(WORD_BITS), x)
        q = x1 // fr
        rem = x1 - q * fr
        x2 = (q << bi) + rem + cd
        x_next = jnp.where(valid, x2, x1)
        return x_next, (word, emit)

    final_x, (words, flags) = jax.lax.scan(
        step, x0, (sym_f, bkt_f, valid_grid), reverse=True,
        unroll=min(SCAN_UNROLL, R),
    )
    return final_x, words, flags


def stream_compact(
    words: jnp.ndarray,  # [R, C, NL] uint16 emission grid
    flags: jnp.ndarray,  # [R, C, NL] bool
    rank: jnp.ndarray,  # [R * C * NL] int32 decode rank of each grid
    # slot (rank[perm[j]] = j for schedule.build_stream_perm's perm;
    # padding slots carry a rank past every real symbol)
    kc: int | None = None,  # real stream capacity K * C (default: grid)
):
    """Device-side global-stream compaction: ONE key sort both reorders
    emissions into decode order and packs flagged words densely
    (round 3; previously a perm gather + cumsum scatter, which profiled
    several times slower than an equal-size sort on the hardware first
    tuned on). Key = decode rank for flagged slots, +inf-like for
    unflagged; ranks are distinct, so the first `total` sorted values
    are the stream. Returns (stream [kc] uint16 zero-padded tail,
    total int32)."""
    big = jnp.int32(1 << 30)
    wflat = words.reshape(-1)
    fflat = flags.reshape(-1)
    if kc is None:
        kc = wflat.shape[0]
    keys = jnp.where(fflat, rank, big)
    _, stream = jax.lax.sort(
        (keys, wflat), dimension=0, is_stable=False, num_keys=1
    )
    stream = stream[:kc]
    total = jnp.sum(fflat.astype(jnp.int32))
    # zero the unflagged tail (sorted there, holds stale words)
    iota = jax.lax.broadcasted_iota(jnp.int32, (kc,), 0)
    stream = jnp.where(iota < total, stream, jnp.uint16(0))
    return stream, total


def stream_compact_grid(
    words: jnp.ndarray,  # [R, C, NL] uint16 emission grid
    flags: jnp.ndarray,  # [R, C, NL] bool
    kc: int,  # real stream capacity K * C
):
    """Sort-free global-stream compaction for mode="grid" (round 5).

    In grid mode the decode order IS the flat [R, C, NL] grid order
    (rows are steps; within a step words go channel-major, lane-minor —
    build_stream_perm degenerates to the identity on valid slots), so
    the global (rank, word) sort of stream_compact over R*C*NL elements
    (the largest stage of the 2048^2 RGB device encode in a round-4
    ablation) is overkill. Instead:

      * pack each row's flagged words with ONE single-operand u32 sort
        along the row: key = (in-row rank if flagged else 0xFFFF) << 16
        | word. Row length C*NL <= 65536 so the rank fits 16 bits; a
        single fused u32 operand sorts ~log2(blk)^2 bitonic passes
        instead of the global sort's log2(R*blk)^2 over a two-operand
        (i32, u16) pair;
      * lay rows end to end with a lax.scan of dynamic_update_slices at
        the running word offset: row r writes its compacted block at
        base[r]; the garbage tail of each block is overwritten by the
        next row's write (writes are contiguous and sequential), so
        positions < total always hold real words.

    Returns (stream [kc] uint16 zero-padded tail, total int32)."""
    R = words.shape[0]
    blk = 1
    for d in words.shape[1:]:
        blk *= d
    assert blk <= (1 << 16), "in-row rank must fit 16 bits"
    w2 = words.reshape(R, blk).astype(jnp.uint32)
    f2 = flags.reshape(R, blk)
    inrow = jnp.arange(blk, dtype=jnp.uint32)
    key = (
        jnp.where(f2, inrow, jnp.uint32(0xFFFF)) << jnp.uint32(16)
    ) | w2
    srt = jax.lax.sort(key, dimension=1, is_stable=False)
    roww = (srt & jnp.uint32(0xFFFF)).astype(jnp.uint16)  # [R, blk]
    cnt = jnp.sum(f2.astype(jnp.int32), axis=1)  # [R]
    base = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(cnt)[:-1]]
    )
    buf0 = jnp.zeros(kc + blk, jnp.uint16)

    def body(buf, xs):
        rw, b = xs
        return jax.lax.dynamic_update_slice(buf, rw, (b,)), None

    buf, _ = jax.lax.scan(body, buf0, (roww, base))
    total = jnp.sum(cnt)
    iota = jax.lax.broadcasted_iota(jnp.int32, (kc,), 0)
    stream = jnp.where(iota < total, buf[:kc], jnp.uint16(0))
    return stream, total


def stream_compact_scatter(
    words: jnp.ndarray,  # [R, C, NL] uint16
    flags: jnp.ndarray,  # [R, C, NL] bool
    kc: int,
):
    """Grid-mode compaction via exclusive prefix sum + one scatter (the
    cumsum alternative to stream_compact_grid, for device A/B): decode
    rank == flat order, so dst = cumsum(flags) - 1; unflagged slots all
    route to the discard index kc (collisions there are garbage that the
    final slice drops). Returns (stream [kc] uint16, total int32)."""
    f = flags.reshape(-1)
    w = words.reshape(-1)
    csum = jnp.cumsum(f.astype(jnp.int32))
    dst = jnp.where(f, csum - 1, kc)
    stream = jnp.zeros(kc + 1, jnp.uint16).at[dst].set(w)[:kc]
    return stream, csum[-1]


def build_merged_decode_table(
    freqs: jnp.ndarray,  # [..., CA, 1024] uint32/int32
    cdfs: jnp.ndarray,  # [..., CA, 1024]
    scale_bits: jnp.ndarray,  # [..., CA] int32, every value <= lut_bits
    lut_bits: int = LUT_BITS,
) -> jnp.ndarray:
    """One [..., CA, 2**lut_bits, 2] u32 table replacing the split
    LUT/freq/cdf tables: entry[..., 0] = (freq << 16) | cdf (unscaled),
    entry[..., 1] = symbol. The decode step then needs ONE
    batched-index gather instead of three.

    Motivation (round-2 scan ablation, benchmarks/scan_ablation.py): on
    the hardware first tuned on, a batched-index gather cost the same
    per step *whatever the table size*, so three separate lookups (bits,
    LUT, freq/cdf) tripled the cost for nothing. The earlier
    merged-table attempt was 2.5x slower end-to-end because its
    table was built WITH batched gathers (freq[sym[p]] style) — ~1e9
    indexed lookups per call. This construction uses only a bincount
    scatter + prefix ops (cumsum/cummax/cummin), exploiting run
    structure: at fine position p inside symbol s's scaled run,
    cdf[s] = run_start >> shift and freq[s] = run_length >> shift.

    Entries are exact at every position the decode step reads
    (fine = slot << (lut_bits - bits), slot in a coded symbol's
    [cdf, cdf + freq) range); other positions carry the containing
    run's entry. Duplicate cdfs resolve to the LAST symbol, matching
    the reference decoder's linear walk (entropy_coding.rs:246-255)."""
    L = int(lut_bits)
    n_fine = 1 << L
    lead = tuple(freqs.shape[:-2])
    ca = freqs.shape[-2]
    axis = freqs.ndim - 1
    shift = (jnp.uint32(L) - scale_bits.astype(jnp.uint32))[..., None]
    cdf_s = (cdfs.astype(jnp.uint32) << shift).astype(jnp.int32)

    rows = ca
    for d in lead:
        rows *= d
    n_tot = rows * n_fine
    row_off = (jnp.arange(rows, dtype=jnp.int32) * n_fine).reshape(
        lead + (ca, 1)
    )
    # route cdf == 2**bits (trailing zero-freq symbols) to a discard slot
    ids = jnp.where(cdf_s < n_fine, cdf_s + row_off, n_tot)
    counts = (
        jnp.zeros(n_tot + 1, jnp.int32)
        .at[ids.reshape(-1)]
        .add(1)[:n_tot]
        .reshape(lead + (ca, n_fine))
    )
    sym = jnp.cumsum(counts, axis=-1) - 1  # [..., CA, n_fine]
    prev = jnp.concatenate(
        [jnp.full(sym.shape[:-1] + (1,), -1, sym.dtype), sym[..., :-1]],
        axis=-1,
    )
    is_start = sym != prev
    pos = jax.lax.broadcasted_iota(jnp.int32, sym.shape, axis)
    start = jax.lax.cummax(jnp.where(is_start, pos, 0), axis=axis)
    markers = jnp.where(is_start, pos, jnp.int32(n_fine))
    rc = jax.lax.cummin(markers, axis=axis, reverse=True)
    nxt = jnp.concatenate(
        [rc[..., 1:], jnp.full(rc.shape[:-1] + (1,), n_fine, rc.dtype)],
        axis=-1,
    )
    sh = shift.astype(jnp.int32)
    freq_u = ((nxt - start) >> sh).astype(jnp.uint32)
    cdf_u = (start >> sh).astype(jnp.uint32)
    word0 = (freq_u << jnp.uint32(16)) | cdf_u
    return jnp.stack([word0, sym.astype(jnp.uint32)], axis=-1)


W32 = 32  # coarse/fine split of the 1024-symbol alphabet (32 x 32)


def prepare_compare_tables(cdfs, scale_bits, alphabet=1024):
    """Precompute the bf16 two-plane cdf tables for the gather-free
    decode step (decode_step_comparefree).

    The round-3 redesign: on the hardware first tuned on, batched-index
    gathers inside the decode scan had a fixed per-step cost whatever
    the table size, while a bf16 one-hot einsum was nearly free. Whether
    that holds on a GPU is open (a decision input for the decode-scan
    kernel). So the per-symbol (sym, freq, cdf) lookup of the
    reference decoder (entropy_coding.rs:180-185,246-255) becomes pure
    compare/reduce arithmetic against cdf STAIRCASES selected by one-hot
    contractions:

      sym  = (# of cdf entries <= slot) - 1        (last wins — exact
              twin of the reference's duplicate-cdf linear walk)
      cdf  = max(cdf entries <= slot)
      freq = min(cdf entries > slot, 2**bits) - cdf  (zero-freq runs
              collapse, so the next *distinct* cdf is cdf[sym]+freq[sym])

    bf16 exactness: one-hot entries are 0/1; cdf values (<= 2**14) are
    split into hi = cdf >> 7 (<= 128) and lo = cdf & 127 (<= 127) planes,
    both exactly representable in bf16 (integers <= 256); each
    contraction has exactly one nonzero term, so the f32-accumulated
    result is exact.

    cdfs: [..., CA, alphabet] int; scale_bits: [..., CA] int (<= 14).
    Returns a dict of planes (all jnp arrays):
      cdf_hi/lo [..., CA, 32, 32] bf16, coarse_hi/lo [..., CA, 33] bf16
      (entry j = cdf[32j], entry 32 = 2**bits sentinel), bits [..., CA]
      bf16.
    """
    ca = cdfs.shape[-2]
    lead = cdfs.shape[:-2]
    c_i = cdfs.astype(jnp.int32)
    sent = (jnp.int32(1) << scale_bits.astype(jnp.int32))[..., None]
    coarse = jnp.concatenate([c_i[..., ::W32], sent], axis=-1)
    full = c_i.reshape(lead + (ca, alphabet // W32, W32))
    return {
        "cdf_hi": (full >> 7).astype(jnp.bfloat16),
        "cdf_lo": (full & 127).astype(jnp.bfloat16),
        "coarse_hi": (coarse >> 7).astype(jnp.bfloat16),
        "coarse_lo": (coarse & 127).astype(jnp.bfloat16),
        "bits": scale_bits.astype(jnp.bfloat16),
    }


def distribute_words(x_new, need, stream, gptr):
    """Shared renorm-word distribution: read the contiguous block of
    words this step consumes (one dynamic_slice at gptr) and route word
    rank pos[lane] to each needing lane. Word order within the step is
    channel-major, lane-minor (schedule.build_stream_perm).

    Returns (x_renormed, gptr'). CALLER CONTRACT: stream zero-padded so
    gptr + C*NL never exceeds its length; x_new already holds the
    pre-renorm state; `need` must already be masked by lane activity."""
    C, NL = x_new.shape
    blk = C * NL
    nf = need.reshape(-1).astype(jnp.int32)
    pos = jnp.cumsum(nf) - 1
    block = jax.lax.dynamic_slice(stream, (gptr,), (blk,))
    if blk <= 2048:
        # one-hot contraction over exact-in-bf16 byte planes (see
        # decode_step_merged docstring for the bf16-truncation hazard
        # that forces the byte split)
        block_bytes = jnp.stack(
            [block & jnp.uint16(0xFF), block >> jnp.uint16(8)], axis=-1
        ).astype(jnp.bfloat16)  # [blk, 2], values <= 255 exact in bf16
        ohp = jnp.asarray(
            (pos[:, None] == jnp.arange(blk, dtype=jnp.int32))
            & (nf[:, None] > 0),
            dtype=jnp.bfloat16,
        )  # [C*NL, blk]
        wb = jnp.einsum(
            "nb,bk->nk", ohp, block_bytes,
            preferred_element_type=jnp.float32,
        ).astype(jnp.uint32)
        w = (wb[..., 0] | (wb[..., 1] << jnp.uint32(8))).reshape(C, NL)
    else:
        w = block[jnp.clip(pos, 0, blk - 1)].reshape(C, NL).astype(
            jnp.uint32
        )
    x_new = jnp.where(need, (x_new << jnp.uint32(WORD_BITS)) | w, x_new)
    return x_new, gptr + jnp.sum(nf)


def comparefree_symbol(
    x: jnp.ndarray,  # [C, NL] uint32 lane states
    oh_bkt: jnp.ndarray,  # [C, NL, CA] bf16 one-hot context buckets
    tabs: dict,  # prepare_compare_tables output
):
    """The gather-free symbol-extraction core of the compare-free step
    (everything except renorm-word distribution — split out so the
    lane-sharded TP decoder can route its own GLOBAL word offsets).
    Returns (sym [C, NL] i32, x_new [C, NL] u32 pre-renorm)."""
    _F32 = jnp.float32

    def sel(plane, spec):
        return jnp.einsum(
            spec, oh_bkt, plane, preferred_element_type=_F32
        )

    bi = sel(tabs["bits"], "cnk,ck->cn").astype(jnp.uint32)
    mask = (jnp.uint32(1) << bi) - jnp.uint32(1)
    slot = (x & mask).astype(jnp.int32)  # [C, NL] < 2**14

    coarse = (
        sel(tabs["coarse_hi"], "cnk,ckj->cnj") * 128.0
        + sel(tabs["coarse_lo"], "cnk,ckj->cnj")
    ).astype(jnp.int32)  # [C, NL, 33]
    le_c = coarse <= slot[..., None]
    sym_hi = jnp.clip(jnp.sum(le_c, axis=-1) - 1, 0, W32 - 1)
    nxt_c = jnp.min(
        jnp.where(le_c, jnp.int32(1 << 30), coarse), axis=-1
    )
    oh_hi = jnp.asarray(
        sym_hi[..., None] == jnp.arange(W32, dtype=jnp.int32),
        dtype=jnp.bfloat16,
    )  # [C, NL, 32]
    Wt = oh_bkt[..., :, None] * oh_hi[..., None, :]  # [C, NL, CA, 32]
    win = (
        jnp.einsum(
            "cnkj,ckja->cna", Wt, tabs["cdf_hi"],
            preferred_element_type=_F32,
        )
        * 128.0
        + jnp.einsum(
            "cnkj,ckja->cna", Wt, tabs["cdf_lo"],
            preferred_element_type=_F32,
        )
    ).astype(jnp.int32)  # [C, NL, 32]
    le_f = win <= slot[..., None]
    sym_lo = jnp.sum(le_f, axis=-1) - 1  # >= 0: win[...,0] == coarse sel
    cdf_sel = jnp.max(jnp.where(le_f, win, 0), axis=-1)
    nxt_f = jnp.min(jnp.where(le_f, jnp.int32(1 << 30), win), axis=-1)
    nxt = jnp.minimum(jnp.minimum(nxt_f, nxt_c), jnp.int32(1 << 14))
    freq = (nxt - cdf_sel).astype(jnp.uint32)
    sym = sym_hi * W32 + sym_lo
    x_new = freq * (x >> bi) + slot.astype(jnp.uint32) - cdf_sel.astype(
        jnp.uint32
    )
    return sym, x_new


def decode_step_comparefree(
    x: jnp.ndarray,  # [C, NL] uint32 lane states
    gptr: jnp.ndarray,  # scalar int32 global stream pointer
    oh_bkt: jnp.ndarray,  # [C, NL, CA] bf16 one-hot context buckets
    active: jnp.ndarray,  # [NL] bool (static lane-activity of the step)
    stream: jnp.ndarray,  # [W] uint16, zero-padded >= C*NL past the end
    tabs: dict,  # prepare_compare_tables output for this image
):
    """One gather-free decode step for all channels x lanes (see
    prepare_compare_tables). Returns (sym [C, NL] i32, x', gptr')."""
    C, NL = x.shape
    sym, x_new = comparefree_symbol(x, oh_bkt, tabs)
    act = jnp.broadcast_to(active[None], (C, NL))
    need = act & (x_new < jnp.uint32(RANS_L))
    x_new, gptr = distribute_words(x_new, need, stream, gptr)
    x_next = jnp.where(act, x_new, x)
    return sym, x_next, gptr


def decode_step_stream(
    x: jnp.ndarray,  # [C, NL] uint32 lane states
    gptr: jnp.ndarray,  # scalar int32 global stream pointer
    buckets: jnp.ndarray,  # [C, NL] int32
    active: jnp.ndarray,  # [C, NL] bool
    stream: jnp.ndarray,  # [W] uint16 global word stream
    lut: jnp.ndarray,  # [C, CA, 2**LUT_BITS] int16 fine-slot -> symbol
    fcd: jnp.ndarray,  # [C, CA, 1024] uint32 packed (freq << 16) | cdf
    scale_bits: jnp.ndarray,  # [C, CA] int32
):
    """One decode step for all channels x lanes against the global
    stream. Word order within the step: channel-major, lane-minor — must
    match schedule.build_stream_perm. Returns (sym [C, NL] i32, x', gptr')."""
    bkt = jnp.clip(buckets, 0, CONTEXT_AMOUNT - 1).astype(jnp.int32)

    g_bits = jax.vmap(lambda tab, bk: tab[bk])
    g_lut = jax.vmap(lambda tab, bk, sl: tab[bk, sl])
    g_tab = jax.vmap(lambda tab, bk, sm: tab[bk, sm])

    bi = g_bits(scale_bits.astype(jnp.uint32), bkt)
    mask = (jnp.uint32(1) << bi) - jnp.uint32(1)
    slot = x & mask
    fine = (slot << (jnp.uint32(LUT_BITS) - bi)).astype(jnp.int32)
    sym = g_lut(lut, bkt, fine).astype(jnp.int32)
    g = g_tab(fcd, bkt, sym)
    fr = g >> jnp.uint32(16)
    cd = g & jnp.uint32(0xFFFF)
    x_new = fr * (x >> bi) + slot - cd
    need = active & (x_new < jnp.uint32(RANS_L))
    nf = need.reshape(-1).astype(jnp.int32)
    pos = jnp.cumsum(nf) - 1  # channel-major, lane-minor ordering
    idx = jnp.clip(gptr + pos, 0, stream.shape[0] - 1)
    w = stream[idx].reshape(need.shape).astype(jnp.uint32)
    x_new = jnp.where(need, (x_new << jnp.uint32(WORD_BITS)) | w, x_new)
    x_next = jnp.where(active, x_new, x)
    return sym, x_next, gptr + jnp.sum(nf)


def decode_step_merged(
    x: jnp.ndarray,  # [C, NL] uint32 lane states
    gptr: jnp.ndarray,  # scalar int32 global stream pointer
    buckets: jnp.ndarray,  # [C, NL] int32
    active: jnp.ndarray,  # [C, NL] bool
    stream: jnp.ndarray,  # [W] uint16, zero-padded >= C*NL past the end
    merged: jnp.ndarray,  # [C, CA, 2**lut_bits, 2] u32 (build_merged_decode_table)
    scale_bits: jnp.ndarray,  # [C, CA] int32, all <= lut_bits
    lut_bits: int = LUT_BITS,
):
    """One decode step against the merged table: the three table lookups
    of decode_step_stream become (a) a one-hot contraction for
    scale_bits (15 entries, exact in f32) and (b) ONE merged-table
    gather; the
    per-step renorm words are read with one dynamic_slice at gptr (the
    words a step consumes are contiguous in the global stream) and
    distributed to lanes by a one-hot einsum over SPLIT BYTES: a
    default-precision einsum may run with bf16-truncated inputs (values
    above 8 significant bits are then corrupted), so the u16 words go
    through as two exact-in-bf16 byte planes and are recombined after
    the contraction.

    CALLER CONTRACT: stream must be zero-padded so gptr + C*NL never
    exceeds its length (dynamic_slice would clamp the start and shift
    the block); all scale_bits must be <= lut_bits. Word order within
    the step is channel-major, lane-minor (build_stream_perm)."""
    C, NL = x.shape
    blk = C * NL
    bkt = jnp.clip(buckets, 0, CONTEXT_AMOUNT - 1).astype(jnp.int32)

    oh = (
        bkt[..., None] == jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)
    ).astype(jnp.float32)  # [C, NL, CA]
    bi = jnp.einsum(
        "cnk,ck->cn", oh, scale_bits.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.uint32)
    mask = (jnp.uint32(1) << bi) - jnp.uint32(1)
    slot = x & mask
    fine = (slot << (jnp.uint32(lut_bits) - bi)).astype(jnp.int32)
    g2 = jax.vmap(lambda t, bk, f: t[bk, f])(merged, bkt, fine)  # [C, NL, 2]
    w0 = g2[..., 0]
    fr = w0 >> jnp.uint32(16)
    cd = w0 & jnp.uint32(0xFFFF)
    sym = g2[..., 1].astype(jnp.int32)
    x_new = fr * (x >> bi) + slot - cd
    need = active & (x_new < jnp.uint32(RANS_L))
    nf = need.reshape(-1).astype(jnp.int32)
    pos = jnp.cumsum(nf) - 1  # channel-major, lane-minor ordering
    block = jax.lax.dynamic_slice(stream, (gptr,), (blk,))
    if blk <= 2048:
        # one-hot contraction: at small blk the [blk, blk] one-hot is
        # tiny and beat the fixed overhead of a batched-index gather
        # (round 2); byte planes keep every value exact in bf16 (see
        # the docstring), and HIGHEST pins f32 whatever the backend's
        # default precision
        block_bytes = jnp.stack(
            [block & jnp.uint16(0xFF), block >> jnp.uint16(8)], axis=-1
        ).astype(jnp.float32)  # [blk, 2] byte planes, each value <= 255
        ohp = (
            (pos[:, None] == jnp.arange(blk, dtype=jnp.int32))
            & (nf[:, None] > 0)
        ).astype(jnp.float32)  # [C*NL, blk]
        wb = jnp.einsum(
            "nb,bk->nk", ohp, block_bytes,
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.uint32)
        w = (wb[..., 0] | (wb[..., 1] << jnp.uint32(8))).reshape(C, NL)
    else:
        # the one-hot is O(blk^2) — 604MB/step at C*NL=12288 (2048 RGB,
        # nl=4096), which made large-image decode einsum-bound. A
        # batched-index gather is linear in blk and far cheaper here.
        w = block[jnp.clip(pos, 0, blk - 1)].reshape(C, NL).astype(
            jnp.uint32
        )
    x_new = jnp.where(need, (x_new << jnp.uint32(WORD_BITS)) | w, x_new)
    x_next = jnp.where(active, x_new, x)
    return sym, x_next, gptr + jnp.sum(nf)
