"""Dense gather-free grid-mode decode (round 3; packed rows round 4).

The decode-scan floor of the step-tensor decoders (pipeline_jax
decode_fused / decode_fused_seg) is their loop-carried random access:
each scan step pays a batched-index neighbour gather and a coefficient
scatter, a fixed cost per step whatever the table size. With the
lattice-grid layout
(fractal/lattice.py) both disappear:

  * coefficients live in dense per-level [A, B] grids; the 6 context
    taps of a whole wave are unit SHIFTS of the parent value grid
    (static pad+slice), after a polyphase parent->child broadcast
    built from gather-free stride plans (fractal/gridplan.py) — a
    per-level interleave of residue-class reads — plus a
    boundary-proportional fixup scatter (the reference's scale-2
    conditional neighbour corrections, wavelet_transform.rs:97-177);
  * the per-row scan body shrinks to the pure rANS state machine
    (ops/rans_jax.decode_step_comparefree — one-hot contractions, no
    table gathers).

Round 4 packs the rANS lanes: rank-within-wave instead of raw grid
cell (fractal/schedule.grid_row_lane). Round 3 made symbols <-> lanes
a pure reshape by rastering each wave's full bounding box, which
padded the scan by ~2.4x rows (647 vs 266 at 2048x2048) and made
grid-mode encode much slower than mode=parallel while decode won.
Packing keeps every scan row fully occupied; the grid <-> packed
conversion is ONE static bulk gather (pack taps) plus ONE static bulk
scatter (unpack values) per wave — outside the loop-carried scan, where they cost bulk-parallel
HBM bandwidth instead of per-step latency. This replaces the
symbol-sequential decode recursion of the reference
(entropy_coding.rs:354-449).

Wire-compatible with the step-tensor decoders on mode="grid"
containers: same stream order (schedule.build_stream_perm, rows are
steps), same context math (ops/jax_ops.contexts_static), same tables.
"""

from __future__ import annotations

import os
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..entropy.tables import ALPHABET_SIZE, CONTEXT_AMOUNT
from ..entropy.tables_jax import finalize_contexts_device
from ..fractal.gridplan import apply_plan
from ..ops import jax_ops as J
from ..ops.rans_jax import decode_step_comparefree, prepare_compare_tables


def _shift2(g, s0: int, s1: int, fill):
    """out[..., a, b] = g[..., a + s0, b + s1]; out-of-bounds -> fill.
    Static pad + slice — XLA lowers to contiguous copies, no gather."""
    A, B = g.shape[-2:]
    p0, q0 = max(0, -s0), max(0, -s1)
    pads = [(0, 0)] * (g.ndim - 2) + [
        (p0, max(0, s0)),
        (q0, max(0, s1)),
    ]
    padded = jnp.pad(g, pads, constant_values=fill)
    i0, j0 = s0 + p0, s1 + q0
    return padded[..., i0 : i0 + A, j0 : j0 + B]


def _broadcast_parent(wp, parent_vg, fill, dtype):
    """Polyphase parent->child value broadcast: per residue class
    (a % m, b % m) apply its gather-free GridPlan to the parent value
    grid, then interleave classes by stack+transpose+reshape (pure
    layout ops). Classes absent from the plan (no occupied cells) read
    as fill; tap_valid masking + fixups make that exact
    (tests/test_lattice.py::test_wave_plans_dense_taps)."""
    A, B = wp.shape
    m = wp.m
    Imax, Jmax = -(-A // m), -(-B // m)
    lead = parent_vg.shape[:-2]  # () packed, (C,) per-channel grids

    def one_class(plan):
        ap = lambda a: apply_plan(plan, a, jnp, fill=fill)
        out = jax.vmap(ap)(parent_vg) if lead else ap(parent_vg)
        oi, oj = plan.out_shape
        if (oi, oj) != (Imax, Jmax):
            out = jnp.pad(
                out,
                [(0, 0)] * len(lead)
                + [(0, Imax - oi), (0, Jmax - oj)],
                constant_values=fill,
            )
        return out

    by_class = {
        (r1, r2): one_class(plan) for r1, r2, plan in wp.classes
    }
    blank = None
    outs = []
    for r1 in range(m):
        for r2 in range(m):
            o = by_class.get((r1, r2))
            if o is None:
                if blank is None:
                    blank = jnp.full(
                        lead + (Imax, Jmax), fill, dtype=dtype
                    )
                o = blank
            outs.append(o)
    nd = len(lead)
    pv = (
        jnp.stack(outs)
        .reshape((m, m) + lead + (Imax, Jmax))
        .transpose(
            tuple(range(2, 2 + nd)) + (2 + nd, 0, 3 + nd, 1)
        )
        .reshape(lead + (Imax * m, Jmax * m))[..., :A, :B]
    )
    return pv


class _WaveDev:
    """Device-resident constants for one grid wave (packed rows) —
    shared by the dense decode AND the dense encode-statistics path
    (build_grid_encode, round 5)."""

    def __init__(self, wp, nl: int, n_slots: int):
        put = jax.device_put
        A, B = wp.shape
        pidx = np.nonzero(wp.active.reshape(-1))[0]
        kw = int(pidx.shape[0])
        rows = -(-kw // nl)  # 0 for empty waves
        self.wp = wp
        self.shape = (A, B)
        self.cells = A * B
        self.kw = kw
        self.rows = rows
        self.kind = wp.kind
        self.group = wp.group
        self.fbkt = wp.fbkt
        self.tap_shift = [
            (int(wp.tap_shift[k, 0]), int(wp.tap_shift[k, 1]))
            for k in range(6)
        ]
        # raster rank within the wave IS the packed lane order
        # (schedule cell_pos is raster-sorted; grid_row_lane packs by
        # rank) — pack/unpack are these static index arrays
        self.pack_idx = put(pidx.astype(np.int32))
        act = np.zeros(max(rows, 1) * nl, dtype=bool)
        act[:kw] = True
        self.active_rows = put(act[: rows * nl].reshape(rows, nl))
        tv = wp.tap_valid.reshape(6, A * B).T[pidx]  # [kw, 6]
        self.tap_valid = put(tv)
        slot = wp.slot_grid.reshape(-1)[pidx]
        assert (slot >= 0).all()
        self.wslot = put(slot.astype(np.int32))
        # encode-side dense constants: cell -> slot gather indices
        # (inactive cells read the fill slot n_slots), occupancy, and
        # dense [6, A, B] tap validity for on-grid context math
        self.active_dense = put(wp.active)
        self.slot_safe = put(
            np.where(
                wp.active.reshape(-1), wp.slot_grid.reshape(-1), n_slots
            ).astype(np.int32)
        )
        self.tap_valid_dense = put(np.ascontiguousarray(wp.tap_valid))
        # fixups split per tap direction (static index arrays, in GRID
        # coordinates — applied to tap planes before packing)
        self.fix = []
        for k in range(6):
            sel = wp.fix_tap == k
            if sel.any():
                self.fix.append(
                    (
                        k,
                        put(wp.fix_tgt[sel].astype(np.int32)),
                        put(wp.fix_src[sel].astype(np.int32)),
                    )
                )


_wavedev_cache = {}


def get_wave_devs(geo, sched, nl: int, n_slots: int):
    """Build (or reuse) the device-resident wave constants for one
    (shape, nl) — shared between build_grid_decode and
    build_grid_encode so pack indices / tap planes upload once."""
    from ..fractal.lattice import build_wave_plans, get_lattice_grids

    key = (geo.height, geo.width, geo.depth, nl)
    waves = _wavedev_cache.get(key)
    if waves is None:
        lg = get_lattice_grids(geo.height, geo.width, geo.depth)
        plans = build_wave_plans(geo, lg)  # raises DenseGridUnavailable
        assert len(plans) == sched.max_wave
        waves = [_WaveDev(wp, nl, n_slots) for wp in plans]
        _wavedev_cache[key] = waves
    return waves


def _tap_planes(wd, pv, parent_vg, packed: bool, C: int, fill):
    """The 6 tap-value planes of a wave: unit shifts of the (broadcast)
    parent value grid pv (static pad+slice) + the scale-2 fixup
    corrections read from the raw parent grid
    (wavelet_transform.rs:97-177 semantics). Returns a 6-list of
    [(C,)A,B] grids (packed u32 or per-channel int16)."""
    planes = []
    fix_by_k = {k: (t, s) for (k, t, s) in wd.fix}
    if parent_vg is not None and fix_by_k:
        pflat = (
            parent_vg.reshape(-1)
            if packed
            else parent_vg.reshape(C, -1)
        )
    for k in range(6):
        t = _shift2(pv, *wd.tap_shift[k], fill)
        if k in fix_by_k:
            tgt, src = fix_by_k[k]
            if packed:
                t = t.reshape(-1).at[tgt].set(
                    pflat[src], unique_indices=True
                ).reshape(wd.shape)
            else:
                t = t.reshape(C, -1).at[:, tgt].set(
                    pflat[:, src], unique_indices=True
                ).reshape((C,) + wd.shape)
        planes.append(t)
    return planes


def _pack_tap_vals(wd, planes, packed: bool, C: int):
    """Pack the 6 tap planes to the wave's active cells and mask by tap
    validity -> [C, kw, 6] int32 (ONE static [kw, 6] row-gather)."""
    from .pipeline_jax import _unpack3

    ts = jnp.stack(planes, axis=-1)  # [(C,)A,B,6]
    if packed:
        vals = _unpack3(ts.reshape(wd.cells, 6)[wd.pack_idx])
    else:
        vals = ts.reshape(C, wd.cells, 6)[:, wd.pack_idx].astype(
            jnp.int32
        )
    return jnp.where(wd.tap_valid[None], vals, 0)


def _plane_contexts(wd, planes, vparams, wparams, packed: bool, C: int):
    """Context buckets + predictions computed ON the dense grid (round
    5): elementwise context math over ~2.5-3x the active cells replaces
    the [kw, 6] pack gather with TWO [kw] pack gathers (buckets,
    preds). Returns ([C, kw] i32 buckets, [C, kw] i32 preds) — same
    values as wave_contexts(_pack_tap_vals(...))."""
    from .pipeline_jax import _unpack3

    tvd = wd.tap_valid_dense  # [6, A, B] bool
    if packed:
        vals = jnp.stack(
            [
                jnp.where(tvd[k], _unpack3(planes[k]), 0)
                for k in range(6)
            ],
            axis=-1,
        )  # [3, A, B, 6] i32
    else:
        vals = jnp.stack(
            [
                jnp.where(tvd[k][None], planes[k].astype(jnp.int32), 0)
                for k in range(6)
            ],
            axis=-1,
        )  # [C, A, B, 6]
    vp_row = vparams[:, wd.group].reshape(C, 1, 1, 6)
    wp_row = wparams[:, wd.group].reshape(C, 1, 1, 6)
    buckets, preds = J.contexts_static(vals, vp_row, wp_row, False)
    if wd.fbkt >= 0:
        buckets = jnp.full_like(buckets, wd.fbkt)
    bk = buckets.reshape(C, wd.cells)[:, wd.pack_idx]
    pr = preds.reshape(C, wd.cells)[:, wd.pack_idx]
    return bk, pr


def build_grid_decode(prog, geo, sched, nl: int, C: int):
    """Build the dense decode for a mode="grid" CodecProgram. Returns a
    function with decode_fused's exact signature (the step tensors
    d_coef..d_fbkt are accepted and ignored), so CodecProgram.decode_exec
    drives it unchanged."""
    from .pipeline_jax import _PACK_ZERO, _inverse_transform_device, _pack3, _unpack3

    n_slots = prog.n_slots
    waves: List[_WaveDev] = get_wave_devs(geo, sched, nl, n_slots)
    rows_total = 0
    for wd, wsize in zip(waves, sched.wave_sizes.tolist()):
        assert wd.kw == wsize
        rows_total += wd.rows
    assert rows_total == prog.rows

    T, N = geo.num_tiles, geo.nodes_per_tile
    depth = geo.depth
    HW = geo.height * geo.width
    packed = C == 3
    fill = _PACK_ZERO if packed else 0
    gdtype = jnp.uint32 if packed else jnp.int16
    # on-grid context math (see _plane_contexts) — round-5 A/B knob,
    # off by default (it did not pay on the hardware first measured)
    use_planectx = os.environ.get("FRAVE_GRID_PLANECTX", "0") == "1"
    iota_ca = jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)

    def decode_fused_grid(
        states, stream, wire_bits, offpk, scpk, vparams, wparams,
        qdiv, tid, lap,
        d_coef, d_active, d_nbr, d_lf, d_grp, d_fbkt,
        pix_inv, node_mask, leaf_inb, lut_bits=None,
    ):
        # --- wire tables (identical to decode_fused / _seg)
        shifts32 = jnp.arange(32, dtype=jnp.uint32)
        off_mask = (
            ((offpk[..., None] >> shifts32) & jnp.uint32(1)) > 0
        ).reshape(C, CONTEXT_AMOUNT, ALPHABET_SIZE)
        zero_hist = jnp.zeros((C, CONTEXT_AMOUNT, ALPHABET_SIZE), jnp.int32)
        bits, _, cdfs_i, _ = finalize_contexts_device(
            zero_hist, lap, bits0=wire_bits, off_mask_in=off_mask,
            scale_idx=scpk,
        )
        tabs = prepare_compare_tables(cdfs_i, bits)

        x = states
        gptr = jnp.int32(0)
        if packed:
            qpad = jnp.full((n_slots + 1,), _PACK_ZERO, jnp.uint32)
        else:
            qpad = jnp.zeros((C, n_slots + 1), dtype=jnp.int16)

        def scan_wave(wd, buckets, preds, x, gptr):
            """rANS-decode one wave's packed rows; returns the wave's
            packed values [C, kw] and the advanced (x, gptr)."""
            rows, kw = wd.rows, wd.kw
            if rows == 0:
                return jnp.zeros((C, 0), jnp.int32), x, gptr
            pad = rows * nl - kw
            bk = jnp.pad(buckets, ((0, 0), (0, pad))).reshape(
                C, rows, nl
            ).transpose(1, 0, 2)  # [rows, C, NL]

            def body(carry, xs):
                x, gptr = carry
                bk_t, act_t = xs
                oh = jnp.asarray(
                    bk_t[..., None] == iota_ca, dtype=jnp.bfloat16
                )
                sym, x, gptr = decode_step_comparefree(
                    x, gptr, oh, act_t, stream, tabs
                )
                return (x, gptr), sym

            with jax.named_scope("rans_scan"):
                (x, gptr), syms = jax.lax.scan(
                    body, (x, gptr), (bk, wd.active_rows)
                )  # syms [rows, C, NL]
            syms = syms.transpose(1, 0, 2).reshape(C, rows * nl)[:, :kw]
            values = J.unpack_signed(syms) + preds  # [C, kw]
            return values, x, gptr

        def to_grid(wd, values, base=None):
            """Scatter packed values onto the wave's dense grid (ONE
            static bulk scatter — outside the scan). base: scatter into
            an existing grid (the DC phase-B merge) instead of fill."""
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

        def wave_contexts(wd, vals, vparams, wparams):
            vp_row = vparams[:, wd.group].reshape(C, 1, 6)
            wp_row = wparams[:, wd.group].reshape(C, 1, 6)
            buckets, preds = J.contexts_static(vals, vp_row, wp_row, False)
            if wd.fbkt >= 0:
                buckets = jnp.full_like(buckets, wd.fbkt)
            return buckets, preds

        def ctx_of(wd, pv, parent_vg, vparams, wparams):
            """Tap planes -> (buckets, preds) [C, kw]. Two routes, same
            values: pack-then-contexts (one [kw, 6] row-gather) or
            contexts-on-the-grid (_plane_contexts: elementwise over the
            dense cells, two [kw] pack gathers) — selected by
            FRAVE_GRID_PLANECTX."""
            planes = _tap_planes(wd, pv, parent_vg, packed, C, fill)
            if use_planectx:
                return _plane_contexts(
                    wd, planes, vparams, wparams, packed, C
                )
            vals = _pack_tap_vals(wd, planes, packed, C)
            return wave_contexts(wd, vals, vparams, wparams)

        def scatter_coefs(qpad, wd, values):
            if packed:
                return qpad.at[wd.wslot].set(
                    _pack3(values), unique_indices=True
                )
            wval = values.astype(jnp.int16)
            return jax.vmap(
                lambda q, v: q.at[wd.wslot].set(v, unique_indices=True)
            )(qpad, wval)

        # ---- wave 0 (DC phase A: context-free) + wave 1 (phase B) ----
        w0, w1, w2 = waves[0], waves[1], waves[2]
        z = jnp.zeros((C, w0.kw, 6), jnp.int32)
        bk0, pr0 = wave_contexts(w0, z, vparams, wparams)
        v0, x, gptr = scan_wave(w0, bk0, pr0, x, gptr)
        qpad = scatter_coefs(qpad, w0, v0)
        dcA = to_grid(w0, v0)

        bk1, pr1 = ctx_of(w1, dcA, None, vparams, wparams)
        v1, x, gptr = scan_wave(w1, bk1, pr1, x, gptr)
        qpad = scatter_coefs(qpad, w1, v1)
        # merge the two disjoint phases into the full DC grid
        dc = to_grid(w1, v1, base=dcA)

        # ---- wave 2 (root-HF: taps = neighbour DC values) ----
        bk2, pr2 = ctx_of(w2, dc, None, vparams, wparams)
        v2, x, gptr = scan_wave(w2, bk2, pr2, x, gptr)
        qpad = scatter_coefs(qpad, w2, v2)

        # ---- HF levels: parent broadcast -> shifts -> scan ----
        parent = to_grid(w2, v2)
        for wd in waves[3:]:
            pv = _broadcast_parent(wd.wp, parent, fill, gdtype)
            bk, pr = ctx_of(wd, pv, parent, vparams, wparams)
            vv, x, gptr = scan_wave(wd, bk, pr, x, gptr)
            qpad = scatter_coefs(qpad, wd, vv)
            parent = to_grid(wd, vv)

        # ---- inverse lifting + pixel assembly (same as decode_fused) --
        if packed:
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

    return decode_fused_grid


def _fit_feats(Xs: jnp.ndarray) -> jnp.ndarray:
    """Width-model design features over tap values [..., 6] f32 — exact
    twin of the step-tensor encode's feats() (context_modeling.rs
    feature set: bias + the 5 gradient magnitudes)."""
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


def build_grid_encode(prog, geo, sched, nl: int, C: int):
    """Dense grid-mode encode statistics (round 5, VERDICT r4 #1).

    Replaces the fused encode's [C, K, 6] scattered neighbour gather
    (~260 ms of the 2048^2 RGB device encode, round-4 ablation) with
    the decode path's shift-plane machinery run in wave order over the
    KNOWN coefficient plane: per wave, the dense value grid comes from
    ONE [cells] slot gather (qpad[slot_safe]), tap values are unit
    shifts (+ scale-2 fixups) of the polyphase-broadcast parent grid,
    predictor Gram fits run on a subsampled pack gather, and contexts
    evaluate elementwise ON the dense grid (_plane_contexts) with only
    [kw]-sized pack gathers. Per-wave packed outputs concatenate in
    schedule order, reproducing the step-tensor path's (symbols,
    buckets) arrays exactly when the fit subsample is disabled
    (differential-tested; with subsampling only the fitted — wire —
    parameters move).

    Reference anchors: taps/features context_modeling.rs:25-77; the fit
    is context_modeling.rs:168,185's lstsq as device Gram/Cholesky.

    Returns stats(qpad, vp_ovr, wp_ovr, use_v, use_w) ->
    (vparams [C, F, 6] f32, wparams, buckets [C, K] i32,
    symbols [C, K] i32)."""
    from .pipeline_jax import _PACK_ZERO, _gram_solve, _unpack3

    n_slots = prog.n_slots
    waves = get_wave_devs(geo, sched, nl, n_slots)
    packed = C == 3
    fill = _PACK_ZERO if packed else 0
    gdtype = jnp.uint32 if packed else jnp.int16
    assert sched.num_fine == len(waves)
    use_plane = os.environ.get("FRAVE_GRID_ENC_PLANECTX", "1") == "1"

    # fit subsample: cap Gram samples per group. The fitted parameters
    # travel on the wire and both coders consume the wire values, so
    # subsampling perturbs only the fit quality (rate), never
    # correctness; at 2^17 samples a 6-param LSQ is statistically
    # saturated (the rate cost on real photos was below 0.2%).
    # FRAVE_FIT_CAP=0 disables (bit-exact vs the step-tensor encode).
    cap = int(os.environ.get("FRAVE_FIT_CAP", str(1 << 17)))
    put = jax.device_put
    sub_idx = []
    for wd in waves:
        stride = -(-wd.kw // cap) if (cap > 0 and wd.kw > cap) else 1
        if stride == 1:
            sub_idx.append((wd.pack_idx, wd.tap_valid, wd.wslot))
            continue
        pidx = np.nonzero(wd.wp.active.reshape(-1))[0]
        sel = pidx[::stride]
        tv = wd.wp.tap_valid.reshape(6, -1).T[sel]
        slot = wd.wp.slot_grid.reshape(-1)[sel]
        assert (slot >= 0).all()
        sub_idx.append(
            (
                put(sel.astype(np.int32)),
                put(tv),
                put(slot.astype(np.int32)),
            )
        )

    _HI = jax.lax.Precision.HIGHEST

    def stats(qpad, vp_ovr, wp_ovr, use_v, use_w):
        def vgrid(wd):
            if packed:
                return qpad[wd.slot_safe].reshape(wd.shape)
            return qpad[:, wd.slot_safe].reshape((C,) + wd.shape)

        w0, w1, w2 = waves[0], waves[1], waves[2]
        # tap-source grids in wave order: dcA (phase-A cells only), the
        # merged DC grid, then each wave's own grid as the next parent
        g0 = vgrid(w0)
        g1 = vgrid(w1)
        if packed:
            dc = jnp.where(w1.active_dense, g1, g0)
        else:
            dc = jnp.where(w1.active_dense[None], g1, g0)
        planes = [None] * len(waves)
        planes[1] = _tap_planes(w1, g0, None, packed, C, fill)
        planes[2] = _tap_planes(w2, dc, None, packed, C, fill)
        parent = vgrid(w2)
        for i in range(3, len(waves)):
            wd = waves[i]
            pv = _broadcast_parent(wd.wp, parent, fill, gdtype)
            planes[i] = _tap_planes(wd, pv, parent, packed, C, fill)
            parent = vgrid(wd)

        # --- predictor fits on the (subsampled) packed taps
        Xs_l, ys_l = [], []
        for i, wd in enumerate(waves):
            cells_s, tv_s, slot_s = sub_idx[i]
            ns = int(cells_s.shape[0])
            if planes[i] is None:  # wave 0: all taps absent -> zeros
                Xs = jnp.zeros((C, ns, 6), jnp.float32)
            else:
                ts = jnp.stack(planes[i], axis=-1)
                if packed:
                    v = _unpack3(ts.reshape(wd.cells, 6)[cells_s])
                else:
                    v = ts.reshape(C, wd.cells, 6)[:, cells_s].astype(
                        jnp.int32
                    )
                Xs = jnp.where(tv_s[None], v, 0).astype(jnp.float32)
            if packed:
                ys = _unpack3(qpad[slot_s]).astype(jnp.float32)
            else:
                ys = qpad[:, slot_s].astype(jnp.float32)
            Xs_l.append(Xs)
            ys_l.append(ys)

        # HIGHEST-precision einsums + the optimization barrier: same
        # self-consistency rationale as the step-tensor encode (wire
        # headers and symbol math must see ONE value of the params)
        G = jnp.stack(
            [
                jnp.einsum("ckx,cky->cxy", X, X, precision=_HI)
                for X in Xs_l
            ],
            axis=1,
        )
        bv = jnp.stack(
            [
                jnp.einsum("ckx,ck->cx", X, y, precision=_HI)
                for X, y in zip(Xs_l, ys_l)
            ],
            axis=1,
        )
        vparams = _gram_solve(G, bv)
        vparams = jnp.where(use_v, vp_ovr, vparams)
        vparams = jax.lax.optimization_barrier(J.f16_wire_round(vparams))

        Gws, bws = [], []
        for g, (X, y) in enumerate(zip(Xs_l, ys_l)):
            pred_g = jnp.einsum(
                "ckx,cx->ck", X, vparams[:, g], precision=_HI
            )
            rg = jnp.abs(y - pred_g)
            Fs = _fit_feats(X)
            Gws.append(jnp.einsum("ckx,cky->cxy", Fs, Fs, precision=_HI))
            bws.append(jnp.einsum("ckx,ck->cx", Fs, rg, precision=_HI))
        wparams = _gram_solve(jnp.stack(Gws, axis=1), jnp.stack(bws, axis=1))
        wparams = jnp.where(use_w, wp_ovr, wparams)
        wparams = jax.lax.optimization_barrier(J.f16_wire_round(wparams))

        # --- per-wave contexts + symbols, packed in schedule order
        bks, syms = [], []
        for i, wd in enumerate(waves):
            if planes[i] is None:
                z = jnp.zeros((C, wd.kw, 6), jnp.int32)
                vp_row = vparams[:, wd.group].reshape(C, 1, 6)
                wp_row = wparams[:, wd.group].reshape(C, 1, 6)
                bk, pr = J.contexts_static(z, vp_row, wp_row, False)
                if wd.fbkt >= 0:
                    bk = jnp.full_like(bk, wd.fbkt)
            elif use_plane:
                bk, pr = _plane_contexts(
                    wd, planes[i], vparams, wparams, packed, C
                )
            else:
                vals = _pack_tap_vals(wd, planes[i], packed, C)
                vp_row = vparams[:, wd.group].reshape(C, 1, 6)
                wp_row = wparams[:, wd.group].reshape(C, 1, 6)
                bk, pr = J.contexts_static(vals, vp_row, wp_row, False)
                if wd.fbkt >= 0:
                    bk = jnp.full_like(bk, wd.fbkt)
            if packed:
                tgt = _unpack3(qpad[wd.wslot])
            else:
                tgt = qpad[:, wd.wslot].astype(jnp.int32)
            bks.append(bk)
            syms.append(J.pack_signed(tgt - pr))
        buckets = jnp.concatenate(bks, axis=1)
        symbols = jnp.concatenate(syms, axis=1)
        return vparams, wparams, buckets, symbols

    return stats
