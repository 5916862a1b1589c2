"""SPMD sharded encode: dp (image batch) x tp (tiles / schedule / lanes).

This is the replacement for the parallelism the reference never
had (SURVEY.md section 2.3; BASELINE.json configs 3+4). One shard_map
program runs the full analyze step:

  * each tp shard lifts its slice of fractal tiles (embarrassingly
    parallel — per-tile trees are independent, wavelet_transform.rs:179);
  * the quantized coefficient plane is rebuilt with `all_gather` over the
    `tp` axis (cross-tile neighbour context reads — the halo exchange of
    the 6-neighbour lattice, prediction.rs:39-53 — ride the device
    interconnect);
  * per-image Gram matrices and context histograms are partial sums over
    the local schedule slice, reduced with `psum(axis='tp')` (the shared
    quantization/context tables collective of the north star);
  * the learned 6x6 solves are tiny and computed replicated on every
    shard;
  * rANS lanes are sharded over `tp` for the entropy scan — lanes are
    fully independent streams by construction (frave_tpu/ops/rans.py).

The `dp` axis never communicates: images are independent (per-image
predictor parameters and tables, as in the reference where every encode is
one image).

Decode-side sharding note: the wavefront decode advances one rANS step at
a time; sharding LANES over `tp` would insert one collective per scan
step (an all-gather of each step's decoded coefficients) — hundreds of
latency-bound collectives per image for no bandwidth win, since the
per-step payload is a few KB. The batch answer is `ShardedDecoder`
below: images shard over the mesh (pure dp — zero communication), and
within a device all lanes/channels of an image decode vectorized. Tile-
sharded decode of a single image remains possible through the same
machinery if a config ever demands it, at the documented latency cost.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map as _shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..images import ColorSpace, ImageMetadata
from ..entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT
from ..fractal.geometry import BASE_FRAC_DEPTH, get_geometry
from ..fractal.schedule import default_num_lanes, get_schedule
from ..ops import jax_ops as J
from ..ops.rans_jax import encode_scan
from ..codec.options import EncoderOptions, quantization_matrix
from ..codec.pipeline_jax import _gram_solve


def _pad_to(x: np.ndarray, size: int, fill, axis: int = 0) -> np.ndarray:
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return np.concatenate([x, np.full(shape, fill, dtype=x.dtype)], axis=axis)


@dataclasses.dataclass
class ShardedEncoder:
    """Compiled dp x tp encode for one (height, width, channels, batch)."""

    height: int
    width: int
    channels: int
    batch: int  # global batch B (must divide by mesh dp)
    mesh: Mesh
    depth: int = BASE_FRAC_DEPTH
    num_lanes: Optional[int] = None
    mode: str = "grid"

    def __post_init__(self):
        h, w, depth, C = self.height, self.width, self.depth, self.channels
        mesh = self.mesh
        dp = mesh.shape["dp"]
        tp = mesh.shape["tp"]
        if self.batch % dp != 0:
            raise ValueError(f"batch {self.batch} not divisible by dp={dp}")

        geo = get_geometry(h, w, depth)
        sched = get_schedule(h, w, depth, mode=self.mode)
        T, N = geo.num_tiles, geo.nodes_per_tile
        K = sched.num_symbols
        HW = h * w

        nl = self.num_lanes or default_num_lanes(K)
        # lanes must split evenly over tp
        nl = max(nl, tp)
        nl = -(-nl // tp) * tp
        self.nl = nl
        if sched.cell_pos is not None:
            # grid mode: waves fill whole packed rows (grid_row_lane);
            # analysis stays in dense tail-padded k-order and a static
            # take lays symbols onto the row grid before the rANS scan
            from ..fractal.schedule import grid_row_lane

            grow, glane, R, _ = grid_row_lane(sched, nl)
            slot = (grow * nl + glane).astype(np.int64)
            lay = np.full(R * nl, -1, dtype=np.int64)
            lay[slot] = np.arange(K, dtype=np.int64)
            self._grid_valid = lay >= 0
            self._grid_lay = np.where(lay >= 0, lay, 0).astype(np.int32)
        else:
            R = -(-K // nl)
            self._grid_lay = self._grid_valid = None
        Kp = -(-K // nl) * nl  # dense analysis padding (k-order)
        Tp = -(-T // tp) * tp
        n_slots_pad = Tp * N  # zero pad slot lives at this index
        self.rows, self.num_symbols = R, K

        # ---- padded host tensors ----
        pg = geo.pixel_gather.astype(np.int32)
        leaf_mask = _pad_to(pg >= 0, Tp, False)
        leaf_safe = _pad_to(np.where(pg >= 0, pg, 0).astype(np.int32), Tp, 0)

        sc = sched.sched_coef.astype(np.int32)
        snbr = sched.sched_nbr.astype(np.int32)
        svalid = _pad_to(np.ones(K, dtype=bool), Kp, False)
        sc_p = _pad_to(np.where(sc >= 0, sc, n_slots_pad), Kp, n_slots_pad)
        snbr_p = _pad_to(
            np.where(snbr >= 0, snbr, n_slots_pad).astype(np.int32), Kp, n_slots_pad
        )
        slf_p = _pad_to(sched.sched_lf.astype(bool), Kp, False)
        sgrp_p = _pad_to(sched.sched_group.astype(np.int32), Kp, 0)
        sfbkt_p = _pad_to(sched.sched_fbkt.astype(np.int32), Kp, -1)
        num_fine = sched.num_fine
        self.num_fine = num_fine

        qn = np.floor(np.log2(np.arange(N) + 1)).astype(np.int32)

        B = self.batch
        Bl = B // dp

        # ---- static halo-exchange plan (the boundary-residue `ppermute`
        # component, SURVEY.md section 2.3 SP/CP row vs prediction.rs:39-53
        # neighbour reads). Tiles shard contiguously over tp; the schedule
        # is RE-GROUPED so each shard analyzes exactly the symbols whose
        # target coefficient it owns. Remote references are then only the
        # neighbour taps that cross the tile-band boundary — a true halo,
        # known statically — so instead of rebuilding the full plane with
        # all_gather, each shard ships just those boundary values to its
        # lattice neighbours: one `lax.ppermute` ring per shard offset.
        # Falls back to all_gather when the halo wouldn't be smaller than
        # the plane (degenerate tiny-image shards).
        own_size = (Tp // tp) * N
        self._halo = None  # (deltas, sizes, send_idx arrays)
        self._inv_perm = None
        if tp > 1:
            refs0 = np.concatenate([sc_p[:, None], snbr_p], axis=1).astype(
                np.int64
            )  # [Kp, 7]; n_slots_pad marks absent
            owner_k = np.where(
                sc_p < n_slots_pad, sc_p // own_size, tp - 1
            ).astype(np.int64)
            counts = np.bincount(owner_k, minlength=tp)
            Kg = int(counts.max())
            Kp2 = Kg * tp
            # grouped k-order: shard-major, original order within a shard
            order = np.argsort(owner_k, kind="stable")  # [Kp]
            perm_g = np.full(Kp2, -1, dtype=np.int64)
            pos = 0
            start = 0
            for s in range(tp):
                cnt = int(counts[s])
                perm_g[s * Kg : s * Kg + cnt] = order[start : start + cnt]
                start += cnt
            pad_g = perm_g < 0
            safe_g = np.where(pad_g, 0, perm_g)
            # inverse: original k -> grouped position (for un-permuting the
            # analyze outputs before the lane-grid reshape)
            inv = np.empty(Kp, dtype=np.int64)
            inv[perm_g[~pad_g]] = np.nonzero(~pad_g)[0]

            refs = np.where(pad_g[:, None], n_slots_pad, refs0[safe_g])
            send: dict = {}  # delta -> per-src local slot arrays
            for s in range(tp):
                r = refs[s * Kg : (s + 1) * Kg].reshape(-1)
                r = r[r < n_slots_pad]
                remote = np.unique(r[r // own_size != s])
                owners = remote // own_size
                for o in np.unique(owners):
                    delta = int((s - o) % tp)
                    lst = send.setdefault(delta, [None] * tp)
                    lst[int(o)] = remote[owners == o] - o * own_size
            deltas = sorted(send)
            Hs = [
                max(len(a) for a in send[d] if a is not None) for d in deltas
            ]
            total_halo = int(sum(Hs))
            if total_halo < own_size:
                base = {}
                acc = own_size
                for d, Hd in zip(deltas, Hs):
                    base[d] = acc
                    acc += Hd
                zero_idx = acc  # one zero slot at the end of the local plane
                send_idx = []
                for d, Hd in zip(deltas, Hs):
                    arr = np.zeros((tp, Hd), dtype=np.int32)
                    for src in range(tp):
                        a = send[d][src]
                        if a is not None:
                            arr[src, : len(a)] = a
                    send_idx.append(arr.reshape(-1))  # [tp*Hd], P("tp")
                # remap grouped references to local-plane indices per shard
                remap = np.full((Kp2, 7), zero_idx, dtype=np.int64)
                for s in range(tp):
                    r = refs[s * Kg : (s + 1) * Kg]
                    o = r // own_size
                    out = np.full(r.shape, zero_idx, dtype=np.int64)
                    mine = o == s
                    out[mine] = r[mine] - s * own_size
                    for d in deltas:
                        src = (s - d) % tp
                        a = send[d][src]
                        if a is None or src == s:
                            continue
                        m = (o == src) & (r < n_slots_pad)
                        if not m.any():
                            continue
                        glob = a + src * own_size  # sorted
                        out[m] = base[d] + np.searchsorted(glob, r[m])
                    remap[s * Kg : (s + 1) * Kg] = out
                self._halo = (tuple(deltas), tuple(Hs), send_idx)
                self._inv_perm = inv
                # re-lay-out every per-symbol schedule tensor in grouped
                # order; padding positions are invalid
                sc_p = remap[:, 0].astype(np.int32)
                snbr_p = remap[:, 1:].astype(np.int32)
                svalid = np.where(pad_g, False, svalid[safe_g])
                slf_p = np.where(pad_g, False, slf_p[safe_g])
                sgrp_p = np.where(pad_g, 0, sgrp_p[safe_g])
                sfbkt_p = np.where(pad_g, -1, sfbkt_p[safe_g])
                Kp = Kp2
        halo = self._halo
        self.halo_enabled = halo is not None

        def analyze_shard(pixels, leaf_safe_l, leaf_mask_l, sc_l, snbr_l,
                          svalid_l, slf_l, sgrp_l, sfbkt_l, qdiv, *send_idx_l):
            # pixels: [Bl, C, HW]; tile/schedule tensors: local tp slices
            leaves = jnp.where(
                leaf_mask_l[None, None], pixels[:, :, leaf_safe_l], 0
            ).astype(jnp.int32)  # [Bl, C, Tl, N]
            coef = J.forward_lifting(leaves, leaf_mask_l[None, None], depth)
            qc = J.quantize(coef, qdiv[None, None, None, :])
            qflat_l = qc.reshape(Bl, C, -1)
            if halo is not None:
                # boundary-residue exchange: one ppermute ring per shard
                # offset, carrying only the statically-known needed slots
                parts = [qflat_l]
                for d, sidx in zip(halo[0], send_idx_l):
                    sv = qflat_l[:, :, sidx]  # [Bl, C, H_d]
                    rv = jax.lax.ppermute(
                        sv, "tp", perm=[(i, (i + d) % tp) for i in range(tp)]
                    )
                    parts.append(rv)
                parts.append(jnp.zeros((Bl, C, 1), jnp.int32))
                qpad = jnp.concatenate(parts, axis=2)  # local plane + halo
            else:
                qflat = jax.lax.all_gather(
                    qflat_l, "tp", axis=2, tiled=True
                )  # [Bl, C, Tp*N]
                qpad = jnp.concatenate(
                    [qflat, jnp.zeros((Bl, C, 1), jnp.int32)], axis=2
                )

            vals = qpad[:, :, snbr_l]  # [Bl, C, Kl, 6]
            target = qpad[:, :, sc_l]  # [Bl, C, Kl]
            hf = svalid_l & (~slf_l)

            Xf = vals.astype(jnp.float32)
            yf = target.astype(jnp.float32)
            gmask = jnp.stack(
                [
                    (hf & (sgrp_l == g)).astype(jnp.float32)
                    for g in range(num_fine)
                ]
            )  # [F, Kl]
            # contract k without materializing the [Bl,C,F,Kl,6] masked
            # design tensor (F grew 3 -> ~11 with the v8 per-level fits).
            # HIGHEST precision + optimization_barrier after the wire
            # rounding: the params feed both the symbol formation and the
            # wire headers, and a duplicated default-precision (reduced
            # precision) fit subgraph can disagree between the two
            # consumers — see
            # the self-consistency note in pipeline_jax.encode_fused.
            _HI = jax.lax.Precision.HIGHEST
            G = jnp.einsum("gk,bckx,bcky->bcgxy", gmask, Xf, Xf, precision=_HI)
            bv = jnp.einsum("gk,bckx,bck->bcgx", gmask, Xf, yf, precision=_HI)
            G = jax.lax.psum(G, "tp")
            bv = jax.lax.psum(bv, "tp")
            vparams = _gram_solve(G, bv)  # [Bl, C, F, 6]
            # f16 wire rounding before any residual math (format v8);
            # J.f16_wire_round pins IEEE RNE with integer ops (see that
            # helper's docstring)
            vparams = jax.lax.optimization_barrier(J.f16_wire_round(vparams))

            vp_by_k = jnp.take_along_axis(
                vparams,
                sgrp_l[None, None, :, None].astype(jnp.int32).repeat(Bl, 0).repeat(C, 1),
                axis=2,
            )  # [Bl, C, Kl, 6]
            pred_fit = jnp.sum(Xf * vp_by_k, axis=-1)
            r = jnp.abs(yf - pred_fit)
            F = jnp.stack(
                [
                    jnp.ones_like(yf),
                    jnp.abs(Xf[..., 0] - Xf[..., 3]),
                    jnp.abs(Xf[..., 1] - Xf[..., 2]),
                    jnp.abs(Xf[..., 4] - Xf[..., 5]),
                    jnp.abs(Xf[..., 1] - Xf[..., 5]),
                    jnp.abs(Xf[..., 2] - Xf[..., 4]),
                ],
                axis=-1,
            )
            Gw = jax.lax.psum(
                jnp.einsum("gk,bckx,bcky->bcgxy", gmask, F, F, precision=_HI),
                "tp",
            )
            bw = jax.lax.psum(
                jnp.einsum("gk,bckx,bck->bcgx", gmask, F, r, precision=_HI),
                "tp",
            )
            wparams = _gram_solve(Gw, bw)
            wparams = jax.lax.optimization_barrier(J.f16_wire_round(wparams))

            def ctx_one(v, lfm, grp, vp, wp):
                return J.contexts(v, lfm, grp, vp, wp)

            buckets, preds = jax.vmap(
                jax.vmap(ctx_one, in_axes=(0, None, None, 0, 0)),
                in_axes=(0, None, None, 0, 0),
            )(vals, slf_l, sgrp_l, vparams, wparams)
            buckets = jnp.where(sfbkt_l[None, None] >= 0, sfbkt_l[None, None], buckets)
            residuals = target - preds
            symbols = jnp.where(svalid_l[None, None], J.pack_signed(residuals), 0)
            buckets = jnp.where(svalid_l[None, None], buckets, 0)

            ids = (
                jnp.arange(C, dtype=jnp.int32)[None, :, None]
                * (CONTEXT_AMOUNT * ALPHABET_SIZE)
                + buckets * ALPHABET_SIZE
                + jnp.clip(symbols, 0, ALPHABET_SIZE - 1)
            )
            inc = svalid_l[None, None].astype(jnp.int32) * jnp.ones_like(ids)

            def hist_one(idrow, incrow):
                return (
                    jnp.zeros(C * CONTEXT_AMOUNT * ALPHABET_SIZE, jnp.int32)
                    .at[idrow.reshape(-1)]
                    .add(incrow.reshape(-1))
                )

            hist = jax.vmap(hist_one)(ids, inc).reshape(
                Bl, C, CONTEXT_AMOUNT, ALPHABET_SIZE
            )
            hist = jax.lax.psum(hist, "tp")
            return symbols, buckets, hist, vparams, wparams

        specs_in = (
            P("dp"),  # pixels [B, C, HW]
            P("tp"),  # leaf_safe [Tp, N]
            P("tp"),  # leaf_mask
            P("tp"),  # sc [Kp] (local-plane indices when halo enabled)
            P("tp"),  # snbr [Kp, 6]
            P("tp"),  # svalid
            P("tp"),  # slf
            P("tp"),  # sgrp
            P("tp"),  # sfbkt
            P(),  # qdiv
        ) + ((P("tp"),) * len(halo[0]) if halo is not None else ())
        specs_out = (
            P("dp", None, "tp"),  # symbols [B, C, Kp]
            P("dp", None, "tp"),  # buckets
            P("dp"),  # hist [B, C, 10, 1024]
            P("dp"),  # vparams
            P("dp"),  # wparams
        )
        self._analyze = jax.jit(
            _shard_map(
                analyze_shard,
                mesh=mesh,
                in_specs=specs_in,
                out_specs=specs_out,
                check_vma=False,
            )
        )

        def entropy_shard(sym_g, bkt_g, val_g, freqs, cdfs, bits):
            # grids: [R, Bl, C, NLl]; tables: [Bl, C, 10, ...]
            return encode_scan(sym_g, bkt_g, val_g, freqs, cdfs, bits)

        self._entropy = jax.jit(
            _shard_map(
                entropy_shard,
                mesh=mesh,
                in_specs=(
                    P(None, "dp", None, "tp"),
                    P(None, "dp", None, "tp"),
                    P(None, "dp", None, "tp"),
                    P("dp"),
                    P("dp"),
                    P("dp"),
                ),
                out_specs=(
                    P("dp", None, "tp"),
                    P(None, "dp", None, "tp"),
                    P(None, "dp", None, "tp"),
                ),
                check_vma=False,
            )
        )

        # ---- on-device table finalization + packed-container assembly
        # (tables_jax is the bit-exact twin of the host tables; the packed
        # layout matches CodecProgram.encode_fused so the host-side fetch/
        # unpack path is shared — no per-context host loops at any batch
        # size, VERDICT round-1 item 5)
        from ..codec.pipeline_jax import _HDR_TABLES, _i32
        from ..entropy.tables import _GRID_LOG2, _LAPLACE_GRID_ROWS
        from ..entropy.tables_jax import (
            finalize_contexts_device,
            select_scales_device,
        )
        from ..fractal.schedule import get_stream_perm
        from ..ops.rans_jax import stream_compact

        # + 1: per-channel expected-code-length f32 (rate-adaptive lanes)
        self.chan_hdr = 12 * self.num_fine + _HDR_TABLES + nl + 1
        self.hdr_words = C * self.chan_hdr + 1
        KC = K * C  # global decode-order stream length (unpadded symbols)
        kcp2 = (KC + 1) // 2
        lap_dev = jnp.asarray(_LAPLACE_GRID_ROWS.astype(np.uint32))
        glog2_dev = jnp.asarray(_GRID_LOG2)
        gzero_dev = jnp.asarray((_LAPLACE_GRID_ROWS == 0).astype(np.float32))
        _pm = get_stream_perm(h, w, nl, depth, self.mode, C)
        _rank = np.full(self.rows * C * nl, 1 << 30, dtype=np.int32)
        _rank[_pm] = np.arange(_pm.shape[0], dtype=np.int32)
        inv_perm_dev = jnp.asarray(_rank)

        def finalize_tables(hist):
            # hist [B, C, CA, 1024] -> device tables for entropy + wire;
            # v9 picks the best Laplace grid scale per context first
            scales = select_scales_device(hist, glog2_dev, gzero_dev)
            bits, freqs, cdfs, off_mask = finalize_contexts_device(
                hist, lap_dev, scale_idx=scales
            )
            # expected code length per channel (header word; see
            # pipeline_jax.encode_fused exp_bits)
            eb = jnp.sum(
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
                axis=(-2, -1),
            )  # [B, C]
            return bits, freqs, cdfs, off_mask, scales, eb

        self._finalize = jax.jit(finalize_tables)

        def pack_one(
            states, words, flags, bits, off_mask, scales, vparams,
            wparams, eb,
        ):
            # single image: states [C, NL], words/flags [R, C, NL],
            # bits [C, CA], off_mask [C, CA, 1024] -> packed i32 vector
            # (same layout as pipeline_jax.encode_fused:319-332)
            stream, total = stream_compact(words, flags, inv_perm_dev, kc=KC)
            if KC % 2:
                stream = jnp.concatenate([stream, jnp.zeros(1, jnp.uint16)])
            # u16 pairs -> u32 words by BITCAST (byte-identical to the
            # strided s[0::2] | s[1::2] << 16 pack — verified — and a
            # pure reinterpret instead of two strided 12M-element reads)
            spk = jax.lax.bitcast_convert_type(
                stream.reshape(-1, 2), jnp.uint32
            ).reshape(-1)
            om = off_mask.reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE // 32, 32)
            shifts = jnp.arange(32, dtype=jnp.uint32)
            ompk = jnp.sum(
                om.astype(jnp.uint32) << shifts, axis=-1, dtype=jnp.uint32
            )
            headers = jnp.concatenate(
                [
                    _i32(vparams).reshape(C, -1),
                    _i32(wparams).reshape(C, -1),
                    bits.astype(jnp.int32),
                    _i32(ompk).reshape(C, -1),
                    scales.astype(jnp.int32),
                    _i32(states),
                    _i32(eb)[:, None],
                ],
                axis=1,
            )
            return jnp.concatenate([headers.reshape(-1), total[None], _i32(spk)])

        def pack_batch(
            states, words, flags, bits, off_mask, scales, vparams,
            wparams, eb,
        ):
            return jax.vmap(pack_one, in_axes=(0, 1, 1, 0, 0, 0, 0, 0, 0))(
                states, words, flags, bits, off_mask, scales, vparams,
                wparams, eb,
            )

        self._pack = jax.jit(pack_batch)
        self.kcp2 = kcp2
        self.fetch_guess = 0

        # device-resident padded constants (+ halo send-index tensors)
        self._consts = tuple(
            jnp.asarray(a)
            for a in (
                leaf_safe, leaf_mask, sc_p, snbr_p, svalid, slf_p, sgrp_p, sfbkt_p,
            )
        )
        self._halo_consts = (
            tuple(jnp.asarray(a) for a in halo[2]) if halo is not None else ()
        )
        self._inv_dev = (
            jnp.asarray(self._inv_perm.astype(np.int32))
            if self._inv_perm is not None
            else None
        )
        self._qn = qn
        self._Kp = R * nl  # lane-grid width (rows x lanes)
        self._lay_dev = (
            jnp.asarray(self._grid_lay)
            if self._grid_lay is not None
            else None
        )
        self._gridvalid_dev = (
            jnp.asarray(self._grid_valid)
            if self._grid_valid is not None
            else None
        )

    # ------------------------------------------------------------------
    def encode_batch(
        self, batch: np.ndarray, opts: Optional[EncoderOptions] = None
    ) -> List[bytes]:
        """batch: [B, H, W, C] uint8 -> list of frif containers."""
        from ..codec.container import serialize

        opts = opts or EncoderOptions()
        if opts.mode != self.mode:
            raise ValueError(
                f"encoder built for mode={self.mode!r}, opts request {opts.mode!r}"
            )
        B, C = self.batch, self.channels
        assert batch.shape == (B, self.height, self.width, C)
        qm = quantization_matrix(opts.quality)
        qdiv = jnp.asarray(qm.astype(np.int32)[self._qn])

        cs = ColorSpace.LUMA if C == 1 else ColorSpace.RGB
        transforms = [0] * B
        if C == 3:
            from ..codec.channel_transform import forward as channel_forward
            from ..images import RasterImage

            lossless = opts.quality.name == "LOSSLESS"
            outs = []
            for b in range(B):
                im, tid = channel_forward(
                    RasterImage.from_array(batch[b], cs),
                    opts.color_transform,
                    lossless,
                )
                outs.append(im.data)
                transforms[b] = tid
            batch = np.stack(outs)
        # uint8 upload (cast to int32 on device after the leaf gather):
        # int32 pixels would quadruple the host->device bytes
        pixels = jnp.asarray(
            batch.reshape(B, -1, C).transpose(0, 2, 1).astype(np.uint8)
        )  # [B, C, HW] uint8
        symbols, buckets, hist, vparams, wparams = self._analyze(
            pixels, *self._consts, qdiv, *self._halo_consts
        )

        # context-table finalization stays ON DEVICE (bit-exact twin of the
        # host tables, frave_tpu/entropy/tables_jax.py) — no B x C x 15
        # host loop at any batch size
        bits, freqs, cdfs, off_mask, scales, eb = self._finalize(hist)

        R, nl = self.rows, self.nl
        if self._inv_dev is not None:
            # analyze ran in owner-grouped symbol order (halo plan);
            # restore canonical k-order before the lane-grid reshape
            symbols = jnp.take(symbols, self._inv_dev, axis=2)
            buckets = jnp.take(buckets, self._inv_dev, axis=2)
        if self._lay_dev is not None:
            # grid mode: lay dense-k symbols onto the packed row grid
            # (per-wave whole rows); pad slots are masked by valid
            symbols = jnp.take(symbols, self._lay_dev, axis=2)
            buckets = jnp.take(buckets, self._lay_dev, axis=2)
            valid = self._gridvalid_dev
        else:
            valid = jnp.asarray(
                _pad_to(np.ones(self.num_symbols, dtype=bool), self._Kp, False)
            )
        sym_g = symbols.reshape(B, C, R, nl).transpose(2, 0, 1, 3)
        bkt_g = buckets.reshape(B, C, R, nl).transpose(2, 0, 1, 3)
        val_g = jnp.broadcast_to(
            valid.reshape(R, nl)[:, None, None, :], (R, B, C, nl)
        )
        states, words, flags = self._entropy(
            sym_g,
            bkt_g,
            val_g,
            freqs.astype(jnp.uint32),
            cdfs.astype(jnp.uint32),
            bits,
        )

        # on-device global-stream compaction + packed-container assembly;
        # the fetch/unpack path is shared with the single-chip pipeline
        packed = self._pack(
            states, words, flags, bits, off_mask, scales, vparams,
            wparams, eb,
        )

        from ..codec.pipeline_jax import _encode_finish

        meta = ImageMetadata(height=self.height, width=self.width, colorspace=cs)
        images = _encode_finish(self, packed, qm, (meta, transforms), opts)
        return [serialize(im) for im in images]


@dataclasses.dataclass
class TPShardedDecoder:
    """Tile/lane-sharded SPMD decode of ONE image across the mesh
    (BASELINE.json config 3 decode side; the capability VERDICT round 1
    flagged as absent).

    The wavefront decode advances one rANS step at a time; its lanes are
    sharded over every device of the mesh. Each step: every shard decodes
    its local lanes' symbols from the replicated coefficient plane, then
    ONE `all_gather` per step ships (value, renorm-flag) pairs — a few KB
    — so all replicas can (a) scatter the step's decoded coefficients and
    (b) compute the global word-stream offsets that interleave lanes
    across shards. This is the documented latency-bound tradeoff
    (sharded-module docstring): one small collective per step buys
    intra-image decode parallelism for images too large for one device."""

    height: int
    width: int
    channels: int
    mesh: Mesh
    depth: int = BASE_FRAC_DEPTH

    def __post_init__(self):
        self._jit_cache = {}

    def _program(self, nl: int, mode: str, W: int):
        from ..codec.pipeline_jax import get_program

        prog = get_program(
            self.height, self.width, self.depth, nl, self.channels, mode
        )
        n_dev = int(self.mesh.devices.size)
        if nl % n_dev != 0:
            raise ValueError(
                f"num_lanes {nl} must divide over {n_dev} devices"
            )
        key = (nl, mode, W)
        fn = self._jit_cache.get(key)
        if fn is None:
            if mode == "grid" and getattr(prog, "_grid_dense", False):
                fn = self._build_grid(prog, nl, n_dev, W)
            else:
                fn = self._build(prog, nl, n_dev, W)
            self._jit_cache[key] = fn
        return prog, fn

    def _build_grid(self, prog, nl, n_dev, W):
        """Grid-mode TP decode (round 5, VERDICT r4 #3): the packed wave
        rows are LANE-sharded over the mesh, so the loop-carried scan
        body is shard-local rANS ALU (rans_jax.comparefree_symbol on
        [C, NL/n] lanes) and the per-step collective carries only the
        per-(shard, channel) renorm-word COUNTS — a [n_dev, C] i32
        all_gather, independent of the coefficient plane — from which
        each shard derives its lanes' global stream offsets
        (channel-major, shard-major-lane order == build_stream_perm).
        This replaces the step-tensor TP path's per-step plane-sized
        (value, flag) all_gather that an analytic model capped at
        ~1.2x. Per WAVE (not per step) one values
        all_gather rebuilds the dense grids for the replicated
        tap-plane machinery; the final pixel gather is sharded over
        the image.

        Three more stages are sharded OUTSIDE the scan (round 5,
        second pass): (a) the per-context freq-table regeneration +
        compare-table build — the C*CONTEXT_AMOUNT contexts are
        flattened, each shard finalizes its slice, and only the tiny
        compare planes (~4 KB/context) are all_gathered; (b) dequant +
        inverse lifting — sharded over the tile axis, one [C, T*N] i32
        leaves all_gather feeds the sharded pixel gather; (c) the
        per-wave coefficient scatter — each wave's wslot indices are
        partitioned by owning shard ON HOST, so every shard scatters
        only its own tiles' slots into a LOCAL slot buffer (no extra
        collective — the buffer is exactly the lifting input). The
        added collectives are one-shot and loop-invariant, so the
        while-body collective stays the [n_dev, C] count gather."""
        from ..codec.grid_decode import (
            _broadcast_parent,
            _tap_planes,
            get_wave_devs,
        )
        from ..codec.pipeline_jax import (
            _PACK_ZERO,
            _inverse_transform_device,
            _pack3,
            _unpack3,
        )
        from ..entropy.tables_jax import finalize_contexts_device
        from ..fractal.geometry import get_geometry
        from ..fractal.schedule import get_schedule
        from ..ops.rans_jax import (
            RANS_L,
            WORD_BITS,
            comparefree_symbol,
            prepare_compare_tables,
        )

        C = self.channels
        NLl = nl // n_dev
        n_slots = prog.n_slots
        HW = self.height * self.width
        T = prog.num_tiles
        N = 1 << self.depth
        depth = self.depth
        axes = tuple(self.mesh.axis_names)
        packed = C == 3
        fill = _PACK_ZERO if packed else 0
        gdtype = jnp.uint32 if packed else jnp.int16
        geo = get_geometry(self.height, self.width, self.depth)
        sched = get_schedule(
            self.height, self.width, self.depth, mode="grid"
        )
        waves = get_wave_devs(geo, sched, nl, n_slots)
        put = jax.device_put
        # per-wave rank -> (cell, tap validity) in the padded [rows, nl]
        # lane grid (padding ranks read cell 0 with all-invalid taps and
        # are masked by active_rows everywhere downstream)
        rank_maps = []
        for wd in waves:
            pidx = np.nonzero(wd.wp.active.reshape(-1))[0]
            rc = np.zeros(max(wd.rows, 1) * nl, np.int32)
            rc[: wd.kw] = pidx
            tv = np.zeros((max(wd.rows, 1) * nl, 6), bool)
            tv[: wd.kw] = wd.wp.tap_valid.reshape(6, -1).T[pidx]
            rank_maps.append(
                (
                    put(rc[: wd.rows * nl].reshape(wd.rows, nl)),
                    put(tv[: wd.rows * nl].reshape(wd.rows, nl, 6)),
                )
            )
        iota_ca = jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)
        iota_dev = jnp.arange(n_dev, dtype=jnp.int32)
        HWl = -(-HW // n_dev)
        HWp = HWl * n_dev
        # sharded table build: flatten the (C, CA) contexts
        Kc = C * CONTEXT_AMOUNT
        Kl = -(-Kc // n_dev)
        Kp = Kl * n_dev
        # sharded lifting + coefficient scatter: tile-axis split
        # (n_slots == T * N; slot // N is the owning tile, so the slot
        # range [s*Tl*N, (s+1)*Tl*N) is exactly shard s's tiles)
        Tl = -(-T // n_dev)
        Tp = Tl * n_dev
        span = Tl * N
        # per-(wave, shard) LOCAL scatter plans: partition each wave's
        # global wslot indices by owning shard on host; rows padded to
        # the wave's max per-shard count with DISTINCT overflow slots
        # (>= span) so unique_indices stays valid
        scat_plans = []
        mxcap = 1
        for wd in waves:
            ws = np.asarray(wd.wslot)
            # a slot outside [0, T * N) would belong to no shard and be
            # dropped without a trace; unique_indices then promises
            # nothing on the GPU
            if ws.size and (ws.min() < 0 or ws.max() >= T * N):
                raise AssertionError(
                    f"wave slots outside [0, {T * N}) in the scatter plan"
                )
            own = ws // span
            mx = 1
            if ws.size:
                mx = max(
                    1,
                    int(np.max(np.bincount(own, minlength=n_dev))),
                )
            mxcap = max(mxcap, mx)
            idxl = span + np.tile(
                np.arange(mx, dtype=np.int32), (n_dev, 1)
            )
            vrk = np.full((n_dev, mx), ws.size, np.int32)
            for s in range(n_dev):
                sel = np.nonzero(own == s)[0]
                idxl[s, : sel.size] = (ws[sel] - s * span).astype(
                    np.int32
                )
                vrk[s, : sel.size] = sel.astype(np.int32)
            scat_plans.append((put(idxl), put(vrk), mx))

        def decode_tp_grid(
            states_l,  # [C, NLl] uint32 (lane-sharded)
            stream,  # [W] uint16 (replicated)
            wire_bits, offpk, scpk, vparams, wparams, qdiv, tid, lap,
        ):
            s_idx = jax.lax.axis_index(axes[0]) if len(axes) == 1 else (
                jax.lax.axis_index(axes[0]) * self.mesh.shape[axes[1]]
                + jax.lax.axis_index(axes[1])
            )
            lane_lo = s_idx * NLl

            # ---- SHARDED table regeneration: each shard finalizes
            # Kl of the Kc = C*CA contexts (the scale_idx branch of
            # finalize_contexts_device is position-independent over
            # the context axis), then only the compare planes —
            # [Kl, 32, 32] bf16 etc., ~4 KB/context — are gathered.
            shifts32 = jnp.arange(32, dtype=jnp.uint32)
            off_mask = (
                ((offpk[..., None] >> shifts32) & jnp.uint32(1)) > 0
            ).reshape(Kc, ALPHABET_SIZE)
            bits_f = jnp.concatenate(
                [
                    wire_bits.reshape(Kc).astype(jnp.int32),
                    jnp.full((Kp - Kc,), 8, jnp.int32),
                ]
            )
            off_f = jnp.concatenate(
                [off_mask, jnp.zeros((Kp - Kc, ALPHABET_SIZE), bool)]
            )
            sc_f = jnp.concatenate(
                [
                    scpk.reshape(Kc).astype(jnp.int32),
                    jnp.zeros((Kp - Kc,), jnp.int32),
                ]
            )
            ctx_lo = s_idx * Kl
            bits_l, _, cdfs_l, _ = finalize_contexts_device(
                jnp.zeros((Kl, ALPHABET_SIZE), jnp.int32),
                lap,
                bits0=jax.lax.dynamic_slice(bits_f, (ctx_lo,), (Kl,)),
                off_mask_in=jax.lax.dynamic_slice(
                    off_f, (ctx_lo, 0), (Kl, ALPHABET_SIZE)
                ),
                scale_idx=jax.lax.dynamic_slice(sc_f, (ctx_lo,), (Kl,)),
            )
            tabs_l = prepare_compare_tables(cdfs_l, bits_l)
            tabs = {
                k: jax.lax.all_gather(v, axes, axis=0, tiled=True)[
                    :Kc
                ].reshape((C, CONTEXT_AMOUNT) + v.shape[1:])
                for k, v in tabs_l.items()
            }

            # LOCAL coefficient buffer: this shard's tile slots plus
            # an overflow region for the scatter-plan padding rows
            if packed:
                qpad = jnp.full(
                    (span + mxcap,), _PACK_ZERO, jnp.uint32
                )
            else:
                qpad = jnp.zeros((C, span + mxcap), dtype=jnp.int16)
            x = states_l
            gptr = jnp.int32(0)

            def ctx_local(wi, wd, planes, vparams, wparams):
                """My lanes' buckets/preds for one wave: local pack
                gather off the replicated tap planes."""
                rows = wd.rows
                rc_all, tv_all = rank_maps[wi]
                rc = jax.lax.dynamic_slice(
                    rc_all, (0, lane_lo), (rows, NLl)
                )
                tv = jax.lax.dynamic_slice(
                    tv_all, (0, lane_lo, 0), (rows, NLl, 6)
                )
                if planes is None:
                    vals = jnp.zeros((C, rows, NLl, 6), jnp.int32)
                else:
                    ts = jnp.stack(planes, axis=-1)
                    if packed:
                        vals = _unpack3(ts.reshape(wd.cells, 6)[rc])
                    else:
                        vals = ts.reshape(C, wd.cells, 6)[:, rc].astype(
                            jnp.int32
                        )
                    vals = jnp.where(tv[None], vals, 0)
                vp_row = vparams[:, wd.group].reshape(C, 1, 1, 6)
                wp_row = wparams[:, wd.group].reshape(C, 1, 1, 6)
                bk, pr = J.contexts_static(vals, vp_row, wp_row, False)
                if wd.fbkt >= 0:
                    bk = jnp.full_like(bk, wd.fbkt)
                return bk, pr  # [C, rows, NLl]

            def scan_wave(wd, bk, pr, x, gptr):
                """rANS-decode my lanes of one wave's rows; per row ONE
                [n_dev, C] count all_gather routes global word offsets.
                Returns (values_local [C, rows, NLl], x, gptr)."""
                rows = wd.rows
                if rows == 0:
                    return jnp.zeros((C, 0, NLl), jnp.int32), x, gptr
                act_all = wd.active_rows  # [rows, nl] (replicated)
                act_l = jax.lax.dynamic_slice(
                    act_all, (0, lane_lo), (rows, NLl)
                )
                oh = jnp.asarray(
                    bk[..., None] == iota_ca, dtype=jnp.bfloat16
                ).transpose(1, 0, 2, 3)  # [rows, C, NLl, CA]

                def body(carry, xs):
                    x, gptr = carry
                    oh_t, act_t = xs
                    sym, x_new = comparefree_symbol(x, oh_t, tabs)
                    act = jnp.broadcast_to(act_t[None], (C, NLl))
                    need = act & (x_new < jnp.uint32(RANS_L))
                    cnt_l = jnp.sum(need.astype(jnp.int32), axis=1)
                    cnts = jax.lax.all_gather(
                        cnt_l, axes, axis=0, tiled=False
                    ).reshape(n_dev, C)  # THE per-step collective
                    total_c = jnp.sum(cnts, axis=0)  # [C]
                    chan_base = jnp.concatenate(
                        [jnp.zeros(1, jnp.int32), jnp.cumsum(total_c)[:-1]]
                    )
                    shard_before = jnp.sum(
                        jnp.where(
                            (iota_dev < s_idx)[:, None], cnts, 0
                        ),
                        axis=0,
                    )  # [C]
                    local_pref = jnp.cumsum(
                        need.astype(jnp.int32), axis=1
                    ) - 1
                    pos = (
                        chan_base[:, None]
                        + shard_before[:, None]
                        + local_pref
                    )
                    idx = jnp.clip(gptr + pos, 0, stream.shape[0] - 1)
                    wrd = stream[idx].astype(jnp.uint32)
                    x_new = jnp.where(
                        need,
                        (x_new << jnp.uint32(WORD_BITS)) | wrd,
                        x_new,
                    )
                    x = jnp.where(act, x_new, x)
                    gptr = gptr + jnp.sum(total_c)
                    return (x, gptr), sym

                (x, gptr), syms = jax.lax.scan(
                    body, (x, gptr), (oh, act_l)
                )  # syms [rows, C, NLl]
                act_b = jnp.broadcast_to(
                    act_l[:, None, :], (rows, C, NLl)
                ).transpose(1, 0, 2)
                values = jnp.where(
                    act_b,
                    J.unpack_signed(syms.transpose(1, 0, 2)) + pr,
                    0,
                )
                return values, x, gptr

            def wave_values(wi, wd, planes, x, gptr):
                bk, pr = ctx_local(wi, wd, planes, vparams, wparams)
                v_l, x, gptr = scan_wave(wd, bk, pr, x, gptr)
                # per-WAVE collective: rebuild the full packed values
                # for the replicated grid/scatter machinery
                v_all = jax.lax.all_gather(
                    v_l, axes, axis=2, tiled=True
                )  # [C, rows, NL]
                values = v_all.reshape(C, wd.rows * nl)[:, : wd.kw]
                return values, x, gptr

            def to_grid(wd, values, base=None):
                if packed:
                    flat = (
                        jnp.full((wd.cells,), _PACK_ZERO, jnp.uint32)
                        if base is None
                        else base.reshape(-1)
                    )
                    return flat.at[wd.pack_idx].set(
                        _pack3(values), unique_indices=True
                    ).reshape(wd.shape)
                flat = (
                    jnp.zeros((C, wd.cells), jnp.int16)
                    if base is None
                    else base.reshape(C, -1)
                )
                return flat.at[:, wd.pack_idx].set(
                    values.astype(jnp.int16), unique_indices=True
                ).reshape((C,) + wd.shape)

            def scatter_coefs(qpad, wi, values):
                """SHARDED: scatter only this shard's slots (local
                indices from the host-partitioned plan); padding rows
                select a zero value column and distinct overflow
                slots."""
                idxl_a, vrk_a, mx = scat_plans[wi]
                il = jax.lax.dynamic_slice(
                    idxl_a, (s_idx, 0), (1, mx)
                ).reshape(mx)
                vr = jax.lax.dynamic_slice(
                    vrk_a, (s_idx, 0), (1, mx)
                ).reshape(mx)
                vpad = jnp.concatenate(
                    [values, jnp.zeros((C, 1), values.dtype)], axis=1
                )
                vsel = vpad[:, vr]
                if packed:
                    return qpad.at[il].set(
                        _pack3(vsel), unique_indices=True
                    )
                return jax.vmap(
                    lambda q, v: q.at[il].set(v, unique_indices=True)
                )(qpad, vsel.astype(jnp.int16))

            # ---- wave chain (same structure as decode_fused_grid)
            w0, w1, w2 = waves[0], waves[1], waves[2]
            v0, x, gptr = wave_values(0, w0, None, x, gptr)
            qpad = scatter_coefs(qpad, 0, v0)
            dcA = to_grid(w0, v0)
            p1 = _tap_planes(w1, dcA, None, packed, C, fill)
            v1, x, gptr = wave_values(1, w1, p1, x, gptr)
            qpad = scatter_coefs(qpad, 1, v1)
            dc = to_grid(w1, v1, base=dcA)
            p2 = _tap_planes(w2, dc, None, packed, C, fill)
            v2, x, gptr = wave_values(2, w2, p2, x, gptr)
            qpad = scatter_coefs(qpad, 2, v2)
            parent = to_grid(w2, v2)
            for wi in range(3, len(waves)):
                wd = waves[wi]
                pv = _broadcast_parent(wd.wp, parent, fill, gdtype)
                pl = _tap_planes(wd, pv, parent, packed, C, fill)
                vv, x, gptr = wave_values(wi, wd, pl, x, gptr)
                qpad = scatter_coefs(qpad, wi, vv)
                parent = to_grid(wd, vv)

            # ---- SHARDED dequant + inverse lifting over the tile
            # axis (lifting is per-tile; the scatter above already
            # filled this shard's local slot buffer; one [C, T*N] i32
            # leaves all_gather feeds the sharded pixel assembly)
            if packed:
                qcoef_l = _unpack3(qpad[:span]).reshape(C, Tl, N)
            else:
                qcoef_l = qpad[:, :span].astype(jnp.int32).reshape(
                    C, Tl, N
                )
            coef_l = J.dequantize(qcoef_l, qdiv[None, None, :])
            nm_l = jax.lax.dynamic_slice(
                node_mask_pad, (s_idx * Tl, 0), (Tl, N)
            )
            lm_l = jax.lax.dynamic_slice(
                leaf_inb_pad, (s_idx * Tl, 0), (Tl, N)
            )
            leaves_l = J.inverse_lifting(
                coef_l, depth, nm_l[None], lm_l[None]
            ).reshape(C, Tl * N)
            leaves = jax.lax.all_gather(
                leaves_l, axes, axis=1, tiled=True
            )[:, : T * N]
            inv_l = jax.lax.dynamic_slice(
                pix_inv_pad, (s_idx * HWl,), (HWl,)
            )
            planes_l = jnp.clip(leaves[:, inv_l], 0, 255)
            if C == 3:
                planes_l = _inverse_transform_device(planes_l, tid)
            return planes_l.astype(jnp.uint8)  # [C, HWl] (sharded)

        # replicated device constants closed over (shard_map lifts them
        # as replicated): tile-padded lifting masks + padded
        # pixel-inverse map (padding tiles are all-masked and sliced
        # off after the leaves all_gather)
        node_mask_pad = jax.device_put(
            np.concatenate(
                [
                    np.asarray(prog._dec_args[7]),
                    np.zeros((Tp - T, N), bool),
                ]
            )
        )
        leaf_inb_pad = jax.device_put(
            np.concatenate(
                [
                    np.asarray(prog._dec_args[8]),
                    np.zeros((Tp - T, N), bool),
                ]
            )
        )
        pix_inv_host = np.asarray(prog._dec_args[6])
        pix_inv_pad = jax.device_put(
            np.concatenate(
                [pix_inv_host, np.zeros(HWp - HW, np.int32)]
            )
        )

        lane_spec = P(None, axes)  # [C, NL] -> lane axis sharded
        in_specs = (
            lane_spec,  # states
            P(),  # stream
            P(), P(), P(), P(), P(), P(), P(), P(),
        )
        return jax.jit(
            _shard_map(
                decode_tp_grid,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=P(None, axes),  # pixels sharded over the image
                check_vma=False,
            )
        )

    def _build(self, prog, nl, n_dev, W):
        from ..entropy.tables_jax import finalize_contexts_device
        from ..ops.rans_jax import (
            LUT_BITS,
            RANS_L,
            WORD_BITS,
            build_merged_decode_table,
        )

        C = self.channels
        NLl = nl // n_dev
        n_slots = prog.n_slots
        HW = self.height * self.width
        T = prog.num_tiles
        N = 1 << self.depth
        depth = self.depth
        axes = tuple(self.mesh.axis_names)

        def decode_tp(
            states_l,  # [C, NLl] uint32 (lane-sharded)
            stream,  # [W] uint16 (replicated)
            wire_bits,
            offpk,
            scpk,  # [C, CA] int32 Laplace-grid scale indices (v9 wire)
            vparams,
            wparams,
            qdiv,
            tid,  # scalar int32 channel-transform id (replicated)
            lap,
            d_coef,  # [S, NL] (replicated; scatter wants all lanes)
            d_active,
            d_nbr_l,  # [S, NLl, 6] lane-sharded gather tensor
            d_lf_l,  # [S, NLl]
            d_grp_l,
            d_fbkt_l,
            pix_inv,
            node_mask,
            leaf_inb,
        ):
            # replicated table regen + LUT (same as decode_fused)
            shifts32 = jnp.arange(32, dtype=jnp.uint32)
            off_mask = (
                ((offpk[..., None] >> shifts32) & jnp.uint32(1)) > 0
            ).reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
            zero_hist = jnp.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), jnp.int32)
            bits, freqs_i, cdfs_i, _ = finalize_contexts_device(
                zero_hist, lap, bits0=wire_bits, off_mask_in=off_mask,
                scale_idx=scpk,
            )
            # ONE merged (sym, freq, cdf) table (decode_step_merged's
            # layout): one batched-index gather instead of three (see
            # rans_jax.build_merged_decode_table)
            merged = build_merged_decode_table(
                freqs_i, cdfs_i, bits, LUT_BITS
            )

            s_idx = jax.lax.axis_index(axes[0]) if len(axes) == 1 else (
                jax.lax.axis_index(axes[0]) * self.mesh.shape[axes[1]]
                + jax.lax.axis_index(axes[1])
            )
            lane_lo = s_idx * NLl

            from ..codec.pipeline_jax import _PACK_ZERO, _pack3, _unpack3

            if C == 3:
                # packed u32 plane: per step ONE local [NLl, 6] gather +
                # ONE replicated [NL] scatter (see pipeline_jax._pack3 —
                # random-access element count is the scan's cost driver)
                qpad0 = jnp.full((n_slots + 1,), _PACK_ZERO, jnp.uint32)
            else:
                qpad0 = jnp.zeros((C, n_slots + 1), dtype=jnp.int32)
            gptr0 = jnp.int32(0)

            g_mrg = jax.vmap(lambda tab, bk, f: tab[bk, f])

            def body(carry, xs):
                qpad, x, gptr = carry
                coef_safe, active_all, nbr_l, lf_l, grp_l, fbkt_l = xs
                # local context computation for this shard's lanes
                if C == 3:
                    vals = _unpack3(qpad[nbr_l])  # [3, NLl, 6]
                else:
                    vals = qpad[:, nbr_l]  # [C, NLl, 6]
                buckets, preds = jax.vmap(
                    lambda v, vp, wp: J.contexts(
                        v, lf_l, grp_l, vp, wp, onehot_params=True
                    )
                )(vals, vparams, wparams)
                buckets = jnp.where(fbkt_l[None] >= 0, fbkt_l[None], buckets)
                act_l = jax.lax.dynamic_slice(
                    active_all, (lane_lo,), (NLl,)
                )
                act = jnp.broadcast_to(act_l[None], (C, NLl))
                # rANS symbol extraction (local): one-hot scale_bits +
                # one merged-table gather
                bkt = jnp.clip(buckets, 0, CONTEXT_AMOUNT - 1).astype(jnp.int32)
                oh = (
                    bkt[..., None]
                    == jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)
                ).astype(jnp.float32)
                bi = jnp.einsum(
                    "cnk,ck->cn", oh, bits.astype(jnp.float32)
                ).astype(jnp.uint32)
                mask = (jnp.uint32(1) << bi) - jnp.uint32(1)
                slot = x & mask
                fine = (slot << (jnp.uint32(LUT_BITS) - bi)).astype(jnp.int32)
                g2 = g_mrg(merged, bkt, fine)
                fr = g2[..., 0] >> jnp.uint32(16)
                cd = g2[..., 0] & jnp.uint32(0xFFFF)
                sym = g2[..., 1].astype(jnp.int32)
                x_new = fr * (x >> bi) + slot - cd
                need = act & (x_new < jnp.uint32(RANS_L))
                values_l = jnp.where(
                    act, J.unpack_signed(sym) + preds, 0
                ).astype(jnp.int32)
                # ONE collective: ship (value, need) for all lanes
                packed = jnp.stack(
                    [values_l, need.astype(jnp.int32)]
                )  # [2, C, NLl]
                allp = jax.lax.all_gather(
                    packed, axes, axis=2, tiled=True
                )  # [2, C, NL]
                values_all = allp[0]
                need_all = allp[1] > 0
                # global stream offsets (channel-major, lane-minor — the
                # build_stream_perm order), then renorm local lanes
                nf = need_all.reshape(-1).astype(jnp.int32)
                pos = (jnp.cumsum(nf) - 1).reshape(C, nl)
                pos_l = jax.lax.dynamic_slice(pos, (0, lane_lo), (C, NLl))
                idx = jnp.clip(gptr + pos_l, 0, stream.shape[0] - 1)
                wrd = stream[idx].astype(jnp.uint32)
                x_new = jnp.where(
                    need, (x_new << jnp.uint32(WORD_BITS)) | wrd, x_new
                )
                x = jnp.where(act, x_new, x)
                gptr = gptr + jnp.sum(nf)
                # replicated scatter of the whole step's coefficients
                if C == 3:
                    wslot = jnp.where(active_all, coef_safe, n_slots)
                    wval = jnp.where(
                        active_all, _pack3(values_all), jnp.uint32(_PACK_ZERO)
                    )
                    qpad = qpad.at[wslot].set(wval)
                else:
                    act_all = jnp.broadcast_to(active_all[None], (C, nl))
                    wslot = jnp.where(act_all, coef_safe[None], n_slots)
                    wval = jnp.where(act_all, values_all, 0)
                    qpad = jax.vmap(lambda q, s, v: q.at[s].set(v))(
                        qpad, wslot, wval
                    )
                return (qpad, x, gptr), None

            from ..ops.rans_jax import SCAN_UNROLL

            (qpad, _, _), _ = jax.lax.scan(
                body,
                (qpad0, states_l, gptr0),
                (d_coef, d_active, d_nbr_l, d_lf_l, d_grp_l, d_fbkt_l),
                unroll=min(SCAN_UNROLL, d_coef.shape[0]),
            )
            if C == 3:
                qcoef = _unpack3(qpad[:n_slots]).reshape(C, T, N)
            else:
                qcoef = qpad[:, :n_slots].reshape(C, T, N)
            coef = J.dequantize(qcoef, qdiv[None, None, :])
            leaves = J.inverse_lifting(
                coef, depth, node_mask[None], leaf_inb[None]
            )
            planes = jnp.clip(leaves.reshape(C, -1)[:, pix_inv], 0, 255)
            if C == 3:
                from ..codec.pipeline_jax import _inverse_transform_device

                planes = _inverse_transform_device(planes, tid)
            return planes.astype(jnp.uint8)  # [C, HW]

        lane_spec = P(None, axes)  # [C, NL] -> lane axis sharded
        in_specs = (
            lane_spec,  # states
            P(),  # stream
            P(),  # bits
            P(),  # offpk
            P(),  # scales
            P(),  # vparams
            P(),  # wparams
            P(),  # qdiv
            P(),  # tid
            P(),  # lap
            P(),  # d_coef (replicated: scatter needs all lanes)
            P(),  # d_active
            P(None, axes),  # d_nbr [S, NL, 6]
            P(None, axes),  # d_lf
            P(None, axes),  # d_grp
            P(None, axes),  # d_fbkt
            P(),
            P(),
            P(),
        )
        return jax.jit(
            _shard_map(
                decode_tp,
                mesh=self.mesh,
                in_specs=in_specs,
                out_specs=P(),  # identical full image on every shard
                check_vma=False,
            )
        )

    def decode(self, blob: bytes):
        """SPMD tp decode of one container across the whole mesh."""
        from ..codec.container import deserialize
        from ..codec.pipeline_jax import _decode_finish, assemble_wire_batch

        im = deserialize(blob)
        meta = im.metadata
        if (meta.height, meta.width) != (self.height, self.width):
            raise ValueError("decoder built for a different image shape")
        wire = assemble_wire_batch([im], im.num_lanes)
        prog, fn = self._program(im.num_lanes, im.mode, wire[1].shape[-1])
        (
            states, streams, bits, offpk, scales, vparams, wparams, qdiv,
            tids,
        ) = wire
        wire_args = (
            jnp.asarray(states[0]),
            jnp.asarray(streams[0]),
            jnp.asarray(bits[0]),
            jnp.asarray(offpk[0]),
            jnp.asarray(scales[0]),
            jnp.asarray(vparams[0]),
            jnp.asarray(wparams[0]),
            jnp.asarray(qdiv[0]),
            jnp.asarray(tids[0]),
            prog._lap,
        )
        if im.mode == "grid" and getattr(prog, "_grid_dense", False):
            # lane-sharded grid path: output is image-sharded [C, HWp]
            pixels = fn(*wire_args)[:, : self.height * self.width]
        else:
            pixels = fn(
                *wire_args,
                *prog._dec_args[:6],
                *prog._dec_args[6:],
            )
        return _decode_finish(pixels[None], meta, self.channels)[0]


@dataclasses.dataclass
class ShardedDecoder:
    """SPMD dp-sharded batched decode: ONE shard_map program over the whole
    mesh; the image batch axis is sharded across every device (all mesh
    axes), the wavefront-schedule tensors are replicated device-resident
    arguments, and each device runs the fused decode scan on its local
    slice. Decode needs no collectives — images are independent — so the
    program contains exactly zero communication; contrast the encode path
    where the tile halo exchange rides `ppermute` (ShardedEncoder)."""

    height: int
    width: int
    channels: int
    mesh: Mesh

    def __post_init__(self):
        self._jit_cache = {}

    def _program(self, nl: int, mode: str, B: int, W: int, lut_bits: int):
        from ..codec.pipeline_jax import get_program

        prog = get_program(
            self.height, self.width, BASE_FRAC_DEPTH, nl, self.channels, mode
        )
        key = (nl, mode, B, W, lut_bits)
        fn = self._jit_cache.get(key)
        if fn is None:
            axes = tuple(self.mesh.axis_names)  # batch shards over ALL axes
            dec = prog._decode_fused
            fn = jax.jit(
                _shard_map(
                    jax.vmap(
                        lambda *a: dec(*a, lut_bits=lut_bits),
                        in_axes=(0,) * 9 + (None,) * 10,
                    ),
                    mesh=self.mesh,
                    in_specs=(P(axes),) * 9 + (P(),) * 10,
                    out_specs=P(axes),
                    check_vma=False,
                ),
            )
            self._jit_cache[key] = fn
        return prog, fn

    def decode_batch(self, blobs: List[bytes]):
        """Decode same-shape containers, images sharded across the mesh.
        Quality may vary per container (per-image dequantization tables).
        Returns decoded RasterImages in input order."""
        from ..codec.container import deserialize
        from ..codec.pipeline_jax import _decode_finish, assemble_wire_batch

        n_dev = self.mesh.devices.size
        images = [deserialize(b) for b in blobs]
        B0 = len(images)
        if B0 == 0:
            return []
        meta = images[0].metadata
        nl = images[0].num_lanes
        mode = images[0].mode
        for im in images:
            if im.metadata != meta or im.num_lanes != nl or im.mode != mode:
                raise ValueError(
                    "batch must share shape, colorspace, lanes and mode"
                )
        # pad the batch to a multiple of the device count (SPMD needs equal
        # local shards); padding replicates the last image and is dropped
        B = -(-B0 // n_dev) * n_dev
        padded = images + [images[-1]] * (B - B0)

        wire = assemble_wire_batch(padded, nl)
        from ..codec.pipeline_jax import pick_lut_bits

        prog, fn = self._program(
            nl, mode, B, wire[1].shape[-1], pick_lut_bits(wire[2])
        )
        pixels_dev = fn(
            *(jnp.asarray(a) for a in wire),
            prog._lap,
            *prog._dec_args,
        )
        out = _decode_finish(pixels_dev, meta, self.channels)
        return out[:B0]
