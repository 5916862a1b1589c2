"""Interleaved-lane rANS entropy coder (numpy host implementation).

Design (data-parallel redesign of entropy_coding.rs:161-352):

  * 32-bit state per lane, 16-bit renormalization words, state domain
    [2^16, 2^32). With per-context scale_bits <= MAX_FREQ_BITS_CAP = 14
    (< 16) each symbol moves at most one 16-bit word in either direction —
    the key invariant that makes both directions branch-free data-parallel
    lane updates. (The reference uses the `rans` crate's 64-bit multi-stream
    coder with byte renorm and one stream per context bucket,
    entropy_coding.rs:278,332-335.)
  * NL lanes; symbol k of the wavefront schedule belongs to lane k mod NL.
    Lane membership is static (unlike the reference, where the stream is
    chosen by the data-dependent bucket, entropy_coding.rs:239), so decode
    can advance all lanes of a wavefront step concurrently; only the
    frequency-table *choice* is data-dependent.
  * Encode pushes each lane's symbols in reverse schedule order
    (LIFO, like the reference's reversed put_at, entropy_coding.rs:332-334)
    and is vectorized over lanes as a reverse scan over the [R, NL] symbol
    grid, emitting a word grid + flag grid.
  * Wire format: ONE global word stream per image, in DECODE order — for
    each wavefront step, for each channel, for each active lane, at most
    one word. By rANS renorm symmetry the word emitted while encoding
    symbol k is the word pulled while decoding symbol k, so the stream
    order is a static permutation of the emission grid
    (frave_tpu/fractal/schedule.build_stream_perm) and no per-lane word
    counts travel in the container.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

RANS_L = 1 << 16  # lower bound of the normalized state interval


def build_symbol_grid(values: np.ndarray, nl: int, pad=0) -> np.ndarray:
    """[K] -> [R, NL] row-major grid, padded with `pad` (invalid slots)."""
    k = values.shape[0]
    r = -(-k // nl) if k else 0
    out = np.full(max(r, 1) * nl, pad, dtype=values.dtype)
    out[:k] = values
    return out.reshape(max(r, 1), nl)


def encode_lanes(
    symbols: np.ndarray,  # [K] uint32 zig-zag symbols in schedule order
    buckets: np.ndarray,  # [K] int32 context bucket per symbol
    freqs: np.ndarray,  # [CA, 1024] uint32
    cdfs: np.ndarray,  # [CA, 1024] uint32
    scale_bits: np.ndarray,  # [CA] int32
    nl: int,
    slot_flat: np.ndarray | None = None,  # [K] row*NL+lane (grid mode)
    num_rows: int | None = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (final_states [NL] u32, word_grid [R, NL] u16,
    flag_grid [R, NL] bool). word_grid[r, l] is the word emitted while
    encoding symbol r*NL+l (valid where flagged). In grid mode
    (slot_flat given) symbol k occupies grid slot slot_flat[k] instead
    of the dense k."""
    K = symbols.shape[0]
    if slot_flat is not None:
        R = int(num_rows)
        sym_g = np.zeros(R * nl, dtype=np.int64)
        bkt_g = np.zeros(R * nl, dtype=np.int64)
        valid_g = np.zeros(R * nl, dtype=bool)
        sym_g[slot_flat] = symbols.astype(np.int64)
        bkt_g[slot_flat] = buckets.astype(np.int64)
        valid_g[slot_flat] = True
        sym_g = sym_g.reshape(R, nl)
        bkt_g = bkt_g.reshape(R, nl)
        valid_g = valid_g.reshape(R, nl)
    else:
        sym_g = build_symbol_grid(symbols.astype(np.int64), nl)
        bkt_g = build_symbol_grid(buckets.astype(np.int64), nl)
        valid_g = build_symbol_grid(np.ones(K, dtype=bool), nl, pad=False)
        R = sym_g.shape[0]

    x = np.full(nl, RANS_L, dtype=np.uint64)
    word_grid = np.zeros((R, nl), dtype=np.uint16)
    flag_grid = np.zeros((R, nl), dtype=bool)

    f = freqs.astype(np.uint64)
    c = cdfs.astype(np.uint64)
    b = scale_bits.astype(np.uint64)

    for r in range(R - 1, -1, -1):
        s = sym_g[r]
        k = bkt_g[r]
        v = valid_g[r]
        fr = np.where(v, f[k, s], 1)
        cd = np.where(v, c[k, s], 0)
        bi = np.where(v, b[k], 0)
        if not np.all(fr[v] > 0):
            bad = np.nonzero(v & (fr == 0))[0]
            raise ValueError(
                f"symbol with zero frequency at grid row {r}, lanes {bad.tolist()}"
            )
        x_max = fr << (np.uint64(32) - bi)
        emit = v & (x >= x_max)
        word_grid[r] = (x & np.uint64(0xFFFF)).astype(np.uint16)
        flag_grid[r] = emit
        x = np.where(emit, x >> np.uint64(16), x)
        x_new = ((x // fr) << bi) + (x % fr) + cd
        x = np.where(v, x_new, x)

    return x.astype(np.uint32), word_grid, flag_grid


def build_stream(
    word_grids: Sequence[np.ndarray],  # per channel [R, NL] u16
    flag_grids: Sequence[np.ndarray],  # per channel [R, NL] bool
    perm: np.ndarray,  # [K * C] int32 (schedule.build_stream_perm)
) -> np.ndarray:
    """Compact per-channel emission grids into the global decode-order
    stream."""
    C = len(word_grids)
    words = np.stack(word_grids, axis=1).reshape(-1)  # [R, C, NL] row-major
    flags = np.stack(flag_grids, axis=1).reshape(-1)
    wp = words[perm]
    fp = flags[perm]
    return wp[fp].astype(np.uint16)


class StreamDecoder:
    """Stateful vectorized decoder over the single global stream.

    Per wavefront step, channels MUST be advanced in ascending order
    (decode_step(ch, ...) for ch = 0..C-1) — that is the stream's word
    order. All lanes of one (step, channel) advance at once.
    """

    def __init__(
        self,
        states: np.ndarray,  # [C, NL] u32
        stream: np.ndarray,  # [W] u16 global stream
        freqs: np.ndarray,  # [C, CA, 1024]
        cdfs: np.ndarray,
        scale_bits: np.ndarray,  # [C, CA]
    ):
        self.x = states.astype(np.uint64).copy()
        self.stream = stream.astype(np.uint64)
        self.gptr = 0
        self.freqs = freqs.astype(np.uint64)
        self.cdfs = cdfs.astype(np.uint64)
        self.scale_bits = scale_bits.astype(np.uint64)

    def decode_step(self, ch: int, buckets: np.ndarray) -> np.ndarray:
        """buckets: [NL] int64, -1 = inactive. Returns symbols [NL] int64
        (undefined where inactive)."""
        x = self.x[ch]
        active = buckets >= 0
        k = np.where(active, buckets, 0)
        bi = self.scale_bits[ch][k]
        mask = (np.uint64(1) << bi) - np.uint64(1)
        slot = x & mask
        cdf_rows = self.cdfs[ch][k]  # [NL, 1024]
        sym = np.sum(cdf_rows <= slot[:, None], axis=1).astype(np.int64) - 1
        fr = self.freqs[ch][k, sym]
        cd = self.cdfs[ch][k, sym]
        x_new = fr * (x >> bi) + slot - cd
        need = active & (x_new < RANS_L)
        offs = np.cumsum(need) - 1
        idx = np.clip(self.gptr + offs, 0, max(self.stream.shape[0] - 1, 0))
        w = self.stream[idx] if self.stream.size else np.zeros(len(idx), np.uint64)
        x_new = np.where(need, (x_new << np.uint64(16)) | w, x_new)
        self.gptr += int(need.sum())
        self.x[ch] = np.where(active, x_new, x)
        return sym
