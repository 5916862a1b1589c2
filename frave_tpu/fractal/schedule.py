"""Wavefront decode schedule: dependency-DAG layering + rANS lane layout.

The decode recursion of the reference is symbol-sequential: each symbol's
context bucket depends on previously decoded coefficients
(entropy_coding.rs:205-264). The dependency structure, however, is static:
a coefficient at level L depends only on (a) its 3 same-level causal
neighbours {left, up-left, up-right} and (b) the fully-decoded parent
level (SURVEY.md section 3.2). This module turns that structure into a
static *wavefront schedule*:

  * Per phase (DC scan, root-HF scan, HF levels 1..depth-1 — the same
    3-phase order as the reference encoder/decoder,
    entropy_coding.rs:284-329,369-441), Kahn longest-path layering over the
    3 causal edges groups symbols into *waves*; every symbol's dependencies
    live in strictly earlier waves, so a whole wave decodes in parallel.
  * Symbols are enumerated in schedule order k = 0..K-1 (waves in order,
    canonical raster order inside a wave) and round-robined over NL
    interleaved rANS lanes: lane(k) = k mod NL. Lane assignment is static,
    so the encoder can build every lane's stream independently (reverse
    scan) and the decoder advances all lanes of a wave chunk at once.

This is the data-parallel replacement for both the serpentine scan order
(wavelet_transform.rs:505-705) and the bucket-indexed 10-stream layout of
the reference (entropy_coding.rs:266-352): stream membership no longer
depends on decoded data, only the *frequency table* choice does.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geometry import FractalGeometry, get_geometry, BASE_FRAC_DEPTH


def _layer_waves(num_nodes: int, deps: np.ndarray) -> np.ndarray:
    """Longest-path layering. deps: [num_nodes, d] int64 node indices or -1.

    Returns wave id per node (0-based). Raises on cycles (geometrically
    impossible for translation-generated causal edges; asserted anyway).
    Uses the native Kahn implementation (csrc) when built.
    """
    if deps.shape[1] == 3:
        from ..native import layer_waves_native

        w = layer_waves_native(deps)
        if w is not None:
            return w.astype(np.int64)
    wave = np.full(num_nodes, -1, dtype=np.int64)
    indeg = np.zeros(num_nodes, dtype=np.int64)
    # adjacency: successors
    succ: List[List[int]] = [[] for _ in range(num_nodes)]
    for i in range(num_nodes):
        for d in deps[i]:
            if d >= 0:
                succ[d].append(i)
                indeg[i] += 1
    from collections import deque

    q = deque(np.nonzero(indeg == 0)[0].tolist())
    wave[list(q)] = 0
    seen = 0
    while q:
        u = q.popleft()
        seen += 1
        for v in succ[u]:
            if wave[u] + 1 > wave[v]:
                wave[v] = wave[u] + 1
            indeg[v] -= 1
            if indeg[v] == 0:
                q.append(v)
    if seen != num_nodes:
        raise AssertionError("cycle in causal dependency graph")
    return wave


@dataclasses.dataclass
class WavefrontSchedule:
    """Static symbol schedule for one geometry (channel-independent)."""

    num_symbols: int  # K
    sched_coef: np.ndarray  # [K] int32 flat coefficient slot
    sched_nbr: np.ndarray  # [K, 6] int32 neighbour value slots (-1 absent)
    sched_lf: np.ndarray  # [K] bool: LF (MED) vs HF (learned linear) context
    # Fine predictor parameter group per symbol: one id per contiguous
    # schedule segment (DC phases, root-HF, then each HF level) — the
    # per-level fits of format v8. The reference's 3 coarse groups
    # (context_modeling.rs:89-101: finest level / next / rest) survive as
    # legacy_of_fine for decoding v7 containers, whose [3, 6] parameter
    # blocks are expanded to [num_fine, 6] via this map.
    sched_group: np.ndarray  # [K] int8 fine predictor parameter group
    legacy_of_fine: np.ndarray  # [num_fine] int8 coarse group of each fine id
    num_fine: int
    sched_fbkt: np.ndarray  # [K] int8 fixed context bucket, -1 = computed
    wave_sizes: np.ndarray  # [num_waves] int32, sums to K
    max_wave: int
    # mode="grid" (round 3): symbols laid out as dense lattice grids
    # (fractal/lattice.py) — the rANS lane layout IS the padded grid
    # raster, so the device converts symbols <-> lanes by reshape alone.
    # wave_cells[w] = flat cell count of wave w's grid region (0 for
    # dense modes); cell_pos[k] = flat cell of symbol k in its wave's
    # region. Lane/row assignment then depends only on NL:
    # row = base_row(wave) + cell // NL, lane = cell % NL, where every
    # wave's region is padded to a whole number of rows.
    wave_cells: Optional[np.ndarray] = None  # [num_waves] int64
    cell_pos: Optional[np.ndarray] = None  # [K] int64

    def lane_of(self, nl: int) -> np.ndarray:
        return (np.arange(self.num_symbols, dtype=np.int64) % nl).astype(np.int32)

    def expand_params(self, p: np.ndarray) -> np.ndarray:
        """Normalize wire predictor parameters to [..., num_fine, 6]:
        v8 rows pass through, v7's 3 coarse rows expand via
        legacy_of_fine."""
        p = np.asarray(p, dtype=np.float32)
        if p.shape[-2] == self.num_fine:
            return p
        if p.shape[-2] == 3:
            return np.ascontiguousarray(
                p[..., self.legacy_of_fine.astype(np.int64), :]
            )
        raise ValueError(
            f"predictor params have {p.shape[-2]} rows; expected 3 or "
            f"{self.num_fine}"
        )


def _build_schedule_grid(geo: FractalGeometry) -> WavefrontSchedule:
    """mode="grid" (round 3): the lattice-grid layout of fractal/
    lattice.py as a wavefront schedule. Same context-model *shape* as
    mode="parallel" (context taps = nbr_par parent slots, one wave per
    HF level, two-phase DC + root-HF over the tile lattice) with two
    deliberate differences:

      * symbol order within a wave is the RASTER ORDER of the wave's
        dense lattice grid (cell (a, b) -> flat a*B + b), and the rANS
        lane layout is that padded raster itself — on device, symbols
        <-> lanes is a reshape, context taps are grid shifts, and the
        decode scatter disappears (see pipeline_jax grid path);
      * the DC phase-A/B split is the spatial checkerboard
        (a + b) % 2 on the tile grid instead of parallel mode's
        arbitrary canonical-index parity — phase-B tiles then always
        have their A-neighbours adjacent on the grid.

    Schedule-driven backends (numpy oracle, sharded decoders) consume
    this like any other mode; only lane/row assignment generalizes via
    (wave_cells, cell_pos)."""
    from ..entropy.tables import CONTEXT_AMOUNT
    from .lattice import get_lattice_grids

    lg = get_lattice_grids(geo.height, geo.width, geo.depth)
    n = geo.nodes_per_tile
    depth = geo.depth
    flat_mask = geo.coef_mask.reshape(-1)

    sched_coef: List[np.ndarray] = []
    sched_nbr: List[np.ndarray] = []
    sched_lf: List[np.ndarray] = []
    sched_group: List[np.ndarray] = []
    sched_fbkt: List[np.ndarray] = []
    wave_sizes: List[int] = []
    wave_cells: List[int] = []
    cell_pos: List[np.ndarray] = []
    legacy_of_fine: List[int] = []

    def fine_group(size: int, legacy: int) -> np.ndarray:
        fid = len(legacy_of_fine)
        legacy_of_fine.append(legacy)
        return np.full(size, fid, dtype=np.int8)

    tg = lg.grids[0]
    At, Bt = tg.shape
    ta, tb = np.nonzero(tg.occ)
    order = np.argsort(ta * Bt + tb, kind="stable")
    ta, tb = ta[order], tb[order]
    tslot = tg.slot[ta, tb]  # t * n (DC slots), raster order
    apar = ((ta + tb) % 2) == 0

    # tile-grid neighbour slots per tap dir (DC slot of the tile at
    # cell + tap_shift, -1 if off-grid/unoccupied)
    def tile_taps(restrict_a: bool) -> np.ndarray:
        out = np.full((ta.shape[0], 6), -1, dtype=np.int64)
        for k in range(6):
            za = ta + tg.tap_shift[k, 0]
            zb = tb + tg.tap_shift[k, 1]
            inb = (za >= 0) & (za < At) & (zb >= 0) & (zb < Bt)
            zs = np.full(ta.shape[0], -1, dtype=np.int64)
            zs[inb] = tg.slot[za[inb], zb[inb]]
            if restrict_a:
                zpar = ((za + zb) % 2) == 0
                zs = np.where(zpar, zs, -1)
            out[:, k] = zs
        return out

    tcell = ta * Bt + tb

    # wave 0: phase A — context-free, widest bucket
    sel = apar
    sched_coef.append(tslot[sel])
    sched_nbr.append(np.full((int(sel.sum()), 6), -1, dtype=np.int64))
    sched_lf.append(np.zeros(int(sel.sum()), dtype=bool))
    sched_group.append(fine_group(int(sel.sum()), 2))
    sched_fbkt.append(np.full(int(sel.sum()), CONTEXT_AMOUNT - 1, dtype=np.int8))
    wave_sizes.append(int(sel.sum()))
    wave_cells.append(At * Bt)
    cell_pos.append(tcell[sel])

    # wave 1: phase B — predicted from decoded A-neighbour DCs
    sel = ~apar
    taps = tile_taps(restrict_a=True)[sel]
    sched_coef.append(tslot[sel])
    sched_nbr.append(taps)
    sched_lf.append(np.zeros(int(sel.sum()), dtype=bool))
    sched_group.append(fine_group(int(sel.sum()), 2))
    sched_fbkt.append(np.full(int(sel.sum()), -1, dtype=np.int8))
    wave_sizes.append(int(sel.sum()))
    wave_cells.append(At * Bt)
    cell_pos.append(tcell[sel])

    # wave 2: root-HF — all tiles, taps = neighbour DCs
    taps = tile_taps(restrict_a=False)
    sched_coef.append(tslot + 1)
    sched_nbr.append(taps)
    sched_lf.append(np.zeros(ta.shape[0], dtype=bool))
    sched_group.append(fine_group(ta.shape[0], 2))
    sched_fbkt.append(np.full(ta.shape[0], -1, dtype=np.int8))
    wave_sizes.append(int(ta.shape[0]))
    wave_cells.append(At * Bt)
    cell_pos.append(tcell)

    # HF levels 1..depth-1: raster order of each level grid, taps from
    # the reference-exact nbr_par tensor (the dense device path
    # reproduces it via grid shifts + the lattice fixup list;
    # differentially tested)
    for L in range(1, depth):
        g = lg.grids[L]
        A, B = g.shape
        ga, gb = np.nonzero(g.occ)
        o = np.argsort(ga * B + gb, kind="stable")
        ga, gb = ga[o], gb[o]
        slots = g.slot[ga, gb]
        present = flat_mask[slots]
        ga, gb, slots = ga[present], gb[present], slots[present]
        nL = slots.shape[0]
        group = 0 if L == depth - 1 else (1 if L == depth - 2 else 2)
        sched_coef.append(slots)
        sched_nbr.append(geo.nbr_par[slots].astype(np.int64))
        sched_lf.append(np.zeros(nL, dtype=bool))
        sched_group.append(fine_group(nL, group))
        sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
        wave_sizes.append(nL)
        wave_cells.append(A * B)
        cell_pos.append(ga * B + gb)

    coef = np.concatenate(sched_coef)
    return WavefrontSchedule(
        num_symbols=int(coef.shape[0]),
        sched_coef=coef.astype(np.int32),
        sched_nbr=np.concatenate(sched_nbr, axis=0).astype(np.int32),
        sched_lf=np.concatenate(sched_lf),
        sched_group=np.concatenate(sched_group),
        legacy_of_fine=np.asarray(legacy_of_fine, dtype=np.int8),
        num_fine=len(legacy_of_fine),
        sched_fbkt=np.concatenate(sched_fbkt).astype(np.int8),
        wave_sizes=np.asarray(wave_sizes, dtype=np.int32),
        max_wave=len(wave_sizes),
        wave_cells=np.asarray(wave_cells, dtype=np.int64),
        cell_pos=np.concatenate(cell_pos).astype(np.int64),
    )


def build_schedule(geo: FractalGeometry, mode: str = "parallel") -> WavefrontSchedule:
    """mode="parity": the reference's context model — 3 same-level causal
    neighbour taps {left, up-left, up-right} + 3 parent-resolution taps
    (context_modeling.rs:25-77); decode waves follow the in-level
    dependency DAG (diagonal wavefronts, mean width ~sqrt(level size)).

    mode="parallel" (the array-first redesign): ALL six directional
    taps read at the parent haar slot, which is fully decoded before a
    level starts — each level is ONE wave, so the decode scan has
    ~levels + tile-wavefront steps instead of thousands. The DC phase
    keeps the tile wavefront (tiles are few); the root-HF phase reads the
    six neighbour tiles' already-decoded DC values (learned 6-tap
    predictor, group 2).
    """
    if mode == "grid":
        return _build_schedule_grid(geo)
    n = geo.nodes_per_tile
    depth = geo.depth
    T = geo.num_tiles

    sched_coef: List[np.ndarray] = []
    sched_nbr: List[np.ndarray] = []
    sched_lf: List[np.ndarray] = []
    sched_group: List[np.ndarray] = []
    wave_sizes: List[int] = []

    sched_fbkt: List[np.ndarray] = []

    # fine group allocator: one id per contiguous segment, remembering
    # which of the reference's 3 coarse groups it belongs to
    legacy_of_fine: List[int] = []

    def fine_group(size: int, legacy: int) -> np.ndarray:
        fid = len(legacy_of_fine)
        legacy_of_fine.append(legacy)
        return np.full(size, fid, dtype=np.int8)

    if mode == "parity":
        # DC + root-HF phases follow the causal tile wavefront
        # (prediction.rs:241-270).
        tile_deps = geo.tile_nbr[:, 0:3].astype(np.int64)
        tile_waves = _layer_waves(T, tile_deps)
        tile_order = np.lexsort((np.arange(T), tile_waves))
        t_sorted = np.arange(T, dtype=np.int64)[tile_order]
        w_sorted = tile_waves[tile_order]
        _, tile_counts = np.unique(w_sorted, return_counts=True)
        for phase_haar in (0, 1):
            coef = (t_sorted * n + phase_haar).astype(np.int64)
            nbr = np.full((T, 6), -1, dtype=np.int64)
            valid = geo.tile_nbr[t_sorted, 0:3] >= 0
            nbr[:, 0:3] = np.where(
                valid,
                geo.tile_nbr[t_sorted, 0:3].astype(np.int64) * n + phase_haar,
                -1,
            )
            sched_coef.append(coef)
            sched_nbr.append(nbr)
            sched_lf.append(np.ones(T, dtype=bool))
            sched_group.append(fine_group(T, 0))
            sched_fbkt.append(np.full(T, -1, dtype=np.int8))
            wave_sizes.extend(tile_counts.tolist())
    else:
        # Array-first DC: TWO waves instead of the O(sqrt(T)) tile
        # wavefront. Phase A: alternate tiles (canonical order) coded
        # context-free in the widest bucket (pred 0 via all-absent taps,
        # bucket forced by sched_fbkt — a few extra bits per A tile).
        # Phase B: remaining tiles predicted from their already-decoded
        # A-neighbour DCs with the learned 6-tap model.
        a_set = np.arange(T) % 2 == 0
        from ..entropy.tables import CONTEXT_AMOUNT

        a_tiles = np.nonzero(a_set)[0].astype(np.int64)
        sched_coef.append(a_tiles * n)
        sched_nbr.append(np.full((a_tiles.size, 6), -1, dtype=np.int64))
        sched_lf.append(np.zeros(a_tiles.size, dtype=bool))
        sched_group.append(fine_group(a_tiles.size, 2))
        sched_fbkt.append(
            np.full(a_tiles.size, CONTEXT_AMOUNT - 1, dtype=np.int8)
        )
        wave_sizes.append(int(a_tiles.size))

        b_tiles = np.nonzero(~a_set)[0].astype(np.int64)
        tn = geo.tile_nbr[b_tiles].astype(np.int64)  # [B, 6]
        nbr_b = np.where((tn >= 0) & a_set[np.clip(tn, 0, None)], tn * n, -1)
        sched_coef.append(b_tiles * n)
        sched_nbr.append(nbr_b)
        sched_lf.append(np.zeros(b_tiles.size, dtype=bool))
        sched_group.append(fine_group(b_tiles.size, 2))
        sched_fbkt.append(np.full(b_tiles.size, -1, dtype=np.int8))
        wave_sizes.append(int(b_tiles.size))

        # root-HF phase: one wave; 6 taps = neighbour tiles' DC values.
        coef = (np.arange(T, dtype=np.int64) * n + 1).astype(np.int64)
        tn = geo.tile_nbr.astype(np.int64)
        nbr = np.where(tn >= 0, tn * n, -1)
        sched_coef.append(coef)
        sched_nbr.append(nbr)
        sched_lf.append(np.zeros(T, dtype=bool))
        sched_group.append(fine_group(T, 2))
        sched_fbkt.append(np.full(T, -1, dtype=np.int8))
        wave_sizes.append(T)

    # --- HF levels 1..depth-1, coarse to fine (entropy_coding.rs:309).
    flat_mask = geo.coef_mask.reshape(-1)
    for L in range(1, depth):
        slots = geo.level_slots[L].astype(np.int64)  # canonical order
        present = flat_mask[slots]
        slots = slots[present]
        nL = slots.shape[0]
        if nL == 0:
            continue
        group = 0 if L == depth - 1 else (1 if L == depth - 2 else 2)

        if mode == "parallel":
            nbr_o = geo.nbr_par[slots].astype(np.int64)
            sched_coef.append(slots)
            sched_nbr.append(nbr_o)
            sched_lf.append(np.zeros(nL, dtype=bool))
            sched_group.append(fine_group(nL, group))
            sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
            wave_sizes.append(nL)
            continue

        nbr = geo.nbr_idx[slots].astype(np.int64)  # [nL, 6]
        # Causal deps = same-level neighbours that are themselves symbols
        # (mask-true). Mask-false neighbours read as constant 0 on both
        # sides (unwrap_or(0)) and impose no ordering. slot -> node via
        # sorted search (vectorized slot_to_node).
        order_s = np.argsort(slots, kind="stable")
        sorted_slots = slots[order_s]
        deps = np.full((nL, 3), -1, dtype=np.int64)
        for k in range(3):
            sk = nbr[:, k]
            present = (sk >= 0) & flat_mask[np.clip(sk, 0, None)]
            pos = np.searchsorted(sorted_slots, np.clip(sk, 0, None))
            pos_c = np.minimum(pos, nL - 1)
            found = present & (sorted_slots[pos_c] == sk)
            deps[:, k] = np.where(found, order_s[pos_c], -1)
        waves = _layer_waves(nL, deps)
        order = np.lexsort((np.arange(nL), waves))
        slots_o = slots[order]
        nbr_o = nbr[order]
        w_o = waves[order]
        _, counts = np.unique(w_o, return_counts=True)

        sched_coef.append(slots_o)
        sched_nbr.append(nbr_o)
        sched_lf.append(np.zeros(nL, dtype=bool))
        sched_group.append(fine_group(nL, group))
        sched_fbkt.append(np.full(nL, -1, dtype=np.int8))
        wave_sizes.extend(counts.tolist())

    coef = np.concatenate(sched_coef)
    nbr = np.concatenate(sched_nbr, axis=0)
    lf = np.concatenate(sched_lf)
    group = np.concatenate(sched_group)
    fbkt = np.concatenate(sched_fbkt)
    ws = np.asarray(wave_sizes, dtype=np.int64)
    assert ws.sum() == coef.shape[0]

    return WavefrontSchedule(
        num_symbols=int(coef.shape[0]),
        sched_coef=coef.astype(np.int32),
        sched_nbr=nbr.astype(np.int32),
        sched_lf=lf,
        sched_group=group,
        legacy_of_fine=np.asarray(legacy_of_fine, dtype=np.int8),
        num_fine=len(legacy_of_fine),
        sched_fbkt=fbkt.astype(np.int8),
        wave_sizes=ws.astype(np.int32),
        max_wave=int(ws.shape[0]),
    )


@dataclasses.dataclass
class LaneSteps:
    """Decode-time step tensors for a given lane count NL.

    Waves are chunked into steps of at most NL symbols; within a step every
    symbol occupies a distinct lane (lane = k mod NL with k the global
    schedule index, contiguous within a step), stored lane-aligned so the
    per-lane rANS state vectors index directly.
    """

    nl: int
    num_steps: int
    step_slot: np.ndarray  # [S, NL] int32 schedule index k or -1
    step_coef: np.ndarray  # [S, NL] int32 flat coefficient slot or -1
    step_nbr: np.ndarray  # [S, NL, 6] int32
    step_lf: np.ndarray  # [S, NL] bool
    step_group: np.ndarray  # [S, NL] int8
    step_fbkt: np.ndarray  # [S, NL] int8 fixed bucket or -1
    step_wave: np.ndarray  # [S] int32 wave id of each step
    # grid mode: step s IS row s of the [R, NL] symbol/word grid (every
    # padded-grid row is one step); dense modes pack waves tightly so a
    # step may straddle rows and the word row of symbol k is k // NL
    rows_are_steps: bool = False


def _steps_from_slot(
    sched: WavefrontSchedule,
    nl: int,
    step_slot: np.ndarray,
    wave_of_step: np.ndarray,
    rows_are_steps: bool,
) -> LaneSteps:
    valid = step_slot >= 0
    safe = np.where(valid, step_slot, 0)
    step_coef = np.where(valid, sched.sched_coef[safe], -1)
    step_nbr = np.where(valid[..., None], sched.sched_nbr[safe], -1)
    step_lf = np.where(valid, sched.sched_lf[safe], False)
    step_group = np.where(valid, sched.sched_group[safe], 0)
    step_fbkt = np.where(valid, sched.sched_fbkt[safe], -1)
    return LaneSteps(
        nl=nl,
        num_steps=step_slot.shape[0],
        step_slot=step_slot.astype(np.int32),
        step_coef=step_coef.astype(np.int32),
        step_nbr=step_nbr.astype(np.int32),
        step_lf=step_lf.astype(bool),
        step_group=step_group.astype(np.int8),
        step_fbkt=step_fbkt.astype(np.int8),
        step_wave=wave_of_step.astype(np.int32),
        rows_are_steps=rows_are_steps,
    )


def grid_row_lane(sched: WavefrontSchedule, nl: int):
    """Grid mode: (row, lane) of every schedule symbol for lane count nl.

    Round 4 — PACKED rows: row = wave base row + rank // nl, lane =
    rank % nl, where rank is the symbol's raster rank WITHIN its wave
    (= its schedule position inside the wave). Round 3 rastered each
    wave's full bounding-box grid into lanes (lane = cell index), which
    made symbols <-> lanes a pure reshape but padded the scan to the
    grids' inactive cells: 647 rows vs the 266-row packed minimum at
    2048x2048 (the padding made grid-mode ENCODE much slower than
    mode=parallel while decode won).
    Packing keeps the scan body gather-free — the compaction moves to
    ONE static bulk gather/scatter per wave, outside the loop-carried
    scan (codec/grid_decode.py). Also returns total rows."""
    assert sched.cell_pos is not None
    sizes = sched.wave_sizes.astype(np.int64)
    rows_per_wave = -(-sizes // nl)  # ceil; 0 rows for empty waves
    base = np.concatenate([[0], np.cumsum(rows_per_wave)])
    wstart = np.concatenate([[0], np.cumsum(sizes)])
    wave_of_sym = np.repeat(np.arange(sched.max_wave, dtype=np.int64), sizes)
    rank = np.arange(sched.num_symbols, dtype=np.int64) - wstart[wave_of_sym]
    row = base[wave_of_sym] + rank // nl
    lane = rank % nl
    return row, lane, int(base[-1]), rows_per_wave


def _build_lane_steps_grid(sched: WavefrontSchedule, nl: int) -> LaneSteps:
    row, lane, S, rows_per_wave = grid_row_lane(sched, nl)
    step_slot = np.full((S, nl), -1, dtype=np.int64)
    step_slot[row, lane] = np.arange(sched.num_symbols, dtype=np.int64)
    wave_of_step = np.repeat(
        np.arange(sched.max_wave, dtype=np.int64), rows_per_wave
    )
    return _steps_from_slot(sched, nl, step_slot, wave_of_step, True)


def build_lane_steps(sched: WavefrontSchedule, nl: int) -> LaneSteps:
    if sched.cell_pos is not None:
        return _build_lane_steps_grid(sched, nl)
    steps: List[Tuple[int, int]] = []  # (k0, len)
    wave_of_step: List[int] = []
    k = 0
    for w, wsize in enumerate(sched.wave_sizes.tolist()):
        rem = wsize
        while rem > 0:
            take = min(rem, nl)
            steps.append((k, take))
            wave_of_step.append(w)
            k += take
            rem -= take
    S = len(steps)
    step_slot = np.full((S, nl), -1, dtype=np.int64)
    for s, (k0, ln) in enumerate(steps):
        ks = np.arange(k0, k0 + ln, dtype=np.int64)
        step_slot[s, ks % nl] = ks
    return _steps_from_slot(
        sched, nl, step_slot, np.asarray(wave_of_step, dtype=np.int64), False
    )


def default_num_lanes(num_symbols: int) -> int:
    """Lane count heuristic: wide enough to keep the decode wavefront fed,
    small enough that per-lane wire overhead (the 4-byte rANS state each
    lane carries in the container) stays under ~0.25 bpp. Since format v4
    the wire holds one global decode-order word stream — there are no
    per-lane counts, so lane count has no u16-width constraint."""
    if num_symbols <= 0:
        return 16
    # cap raised 4096 -> 16384 in round 2: decode time was dominated by
    # a fixed per-wavefront-step cost on the hardware first tuned on,
    # and 4x the lanes means a quarter of the decode steps for ~4% more
    # wire bytes (per-lane state overhead stays ~2.5B/lane, = K//128
    # lanes max). Not yet re-decided on a GPU.
    target = max(16, min(16384, num_symbols // 128))
    return 1 << (int(target).bit_length() - 1)


def rate_adaptive_lanes(
    default_nl: int, est_payload_bytes: float, channels: int
) -> int:
    """Shrink the lane count when per-lane wire overhead would dominate
    the container (round 4, the flat-content rate fix).

    Each lane costs ~2-4 B/channel on the wire (the STT state block,
    container.py, plus up-to-a-word of per-lane flush rounding). On
    flat/graphic content the entropy-coded payload is tiny — e.g. the
    reference repo's fractals.gif grays to ~1.3 KB of symbol payload,
    where the default 4096 lanes added ~15 KB of overhead (12.8x PNG,
    round 4). Cap lanes so overhead stays <= ~12.5% of the
    expected payload, with a floor of 256 so decode keeps a useful
    wavefront (rows = K / nl; rate-focused callers can pin
    EncoderOptions.num_lanes lower, throughput-focused ones higher)."""
    cap = max(256.0, est_payload_bytes / (32.0 * max(channels, 1)))
    nl = 1 << (int(cap).bit_length() - 1)
    return min(default_nl, nl)


_sched_cache: Dict[Tuple[int, int, int, str], WavefrontSchedule] = {}
_lane_cache: Dict[Tuple[int, int, int, int, str], LaneSteps] = {}
_lock = threading.Lock()


def get_schedule(
    height: int, width: int, depth: int = BASE_FRAC_DEPTH, mode: str = "parallel"
) -> WavefrontSchedule:
    key = (height, width, depth, mode)
    with _lock:
        s = _sched_cache.get(key)
    if s is None:
        s = build_schedule(get_geometry(height, width, depth), mode)
        with _lock:
            _sched_cache[key] = s
    return s


def get_lane_steps(
    height: int,
    width: int,
    nl: int,
    depth: int = BASE_FRAC_DEPTH,
    mode: str = "parallel",
) -> LaneSteps:
    key = (height, width, depth, nl, mode)
    with _lock:
        s = _lane_cache.get(key)
    if s is None:
        s = build_lane_steps(get_schedule(height, width, depth, mode), nl)
        with _lock:
            _lane_cache[key] = s
    return s


def build_stream_perm(steps: LaneSteps, channels: int) -> np.ndarray:
    """Static permutation mapping global-stream position -> source index.

    The rANS word stream is stored in DECODE order: for each wavefront
    step, for each channel, for each active lane (ascending), at most one
    word. The encoder emits words indexed by the [R, C, NL] symbol grid
    (row r = symbols [r*NL, (r+1)*NL)); by rANS renorm symmetry the word
    emitted while ENCODING symbol k is exactly the word pulled while
    DECODING symbol k, so the stream order is the static map below and no
    per-lane word counts need to travel in the container.

    Returns perm [K * channels] int32: perm[j] is the flat index into the
    row-major [R, C, NL] grid whose word (if flagged) occupies stream
    slot rank j among flagged entries.
    """
    nl = steps.nl
    valid = steps.step_slot >= 0  # [S, NL]
    s_idx, l_idx = np.nonzero(valid)  # (s, lane)-ordered
    k = steps.step_slot[valid].astype(np.int64)
    if steps.rows_are_steps:
        r, lane = s_idx.astype(np.int64), l_idx.astype(np.int64)
    else:
        r = k // nl
        lane = k % nl
        assert np.array_equal(lane, l_idx)
    C = channels
    K = k.shape[0]
    src = ((r[:, None] * C + np.arange(C)[None, :]) * nl + lane[:, None]).reshape(-1)
    sS = np.repeat(s_idx, C)
    cC = np.tile(np.arange(C), K)
    lL = np.repeat(lane, C)
    order = np.lexsort((lL, cC, sS))  # sort by (step, channel, lane)
    return src[order].astype(np.int32)


_perm_cache: Dict[Tuple[int, int, int, int, str, int], np.ndarray] = {}


def get_stream_perm(
    height: int,
    width: int,
    nl: int,
    depth: int = BASE_FRAC_DEPTH,
    mode: str = "parallel",
    channels: int = 1,
) -> np.ndarray:
    key = (height, width, nl, depth, mode, channels)
    with _lock:
        p = _perm_cache.get(key)
    if p is None:
        p = build_stream_perm(get_lane_steps(height, width, nl, depth, mode), channels)
        with _lock:
            _perm_cache[key] = p
    return p
