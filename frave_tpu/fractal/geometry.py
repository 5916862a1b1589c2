"""Fractal tiling geometry as dense index tensors.

This replaces the reference's per-image pointer structures — per-tile
binary trees + HashMaps (wavelet_transform.rs:41-69), the BFS tile lattice
(wavelet_transform.rs:450-484), global position maps
(wavelet_transform.rs:434-448) and the directional neighbour getters with
their scale-2 irregularity fixups (wavelet_transform.rs:71-177) — with a
one-time host computation per (height, width, depth) producing numpy index
tensors. The device pipeline (lifting, prediction, entropy coding) is then
pure gather/scatter over these tensors with zero hash lookups.

Deliberate re-design vs the reference (documented divergences):
  * The serpentine per-level scan (`sort_lattice`/`scan_level`,
    wavelet_transform.rs:505-705 — the "logic from hell") only ever served
    two purposes: a deterministic canonical symbol order, and causal
    ordering of the {left, up-left, up-right} context neighbours. Both are
    provided here by (a) raster-canonical ordering (sort by (im, re), the
    reference's own unused `order_complex`, utils.rs:17-32) and (b) an
    explicit dependency-DAG wavefront layering (frave_tpu/fractal/
    schedule.py) which is provably causal by construction and is also the
    parallel decode schedule. Bitstreams are therefore not byte-compatible
    with the Rust CLI — decoded pixels are what must match.
  * Neighbour *semantics* are replicated exactly, including the scale-2
    conditional fixups and the reference's quirk of indexing the global
    position map by scale (not level) inside those fixups
    (wavelet_transform.rs:115-177).

Coordinate conventions: a position is a complex integer (re, im) with
re = x (column) and im = y (row), matching RasterImage::get_pixel
(images.rs:93-103). A "flat coefficient index" is tile_index * 2**depth +
haar_index, indexing the [num_tiles, 2**depth] coefficient tensor.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Tuple

import numpy as np

from .literals import LITERALS

# Fixed tile depth: 512 pixels per tile (reference wavelet_transform.rs:39).
BASE_FRAC_DEPTH = 9

Pos = Tuple[int, int]


def nearby_vectors(scale: int) -> List[Pos]:
    """Six neighbour displacement vectors at a given scale.

    scale = depth - level. Hand-special-cased scales 1-3 exactly as the
    reference (wavelet_transform.rs:71-90). Order matters: the directional
    getters index this list.
    """
    if scale == 1:
        zl, zmd = (-1, 1), (0, 2)
    elif scale == 2:
        zl, zmd = (-2, 0), (0, -2)
    elif scale == 3:
        zl, zmd = (-3, -1), (-1, -3)
    else:
        zl = LITERALS[scale]
        l1 = LITERALS[scale + 1]
        zmd = (l1[0] + zl[0], l1[1] + zl[1])
    return [
        zl,
        (zl[0] - zmd[0], zl[1] - zmd[1]),
        (-zmd[0], -zmd[1]),
        (-zl[0], -zl[1]),
        (zmd[0] - zl[0], zmd[1] - zl[1]),
        zmd,
    ]


def _add(a: Pos, b: Pos) -> Pos:
    return (a[0] + b[0], a[1] + b[1])


# Directional neighbour getters. The scale-2 fixups test membership in the
# global position map indexed by *scale* — replicating the reference
# verbatim (wavelet_transform.rs:115-177 index `global_position_map[depth]`
# where `depth` is the scale argument). `maps` is the per-level list of
# position dicts; `maps[scale]` can therefore be a different level than the
# one being queried. This is a reference quirk we keep for modeling parity.


def get_left(c: Pos, scale: int, maps) -> Pos:
    return _add(c, nearby_vectors(scale)[4])


def get_right(c: Pos, scale: int, maps) -> Pos:
    return _add(c, nearby_vectors(scale)[1])


def get_down_left(c: Pos, scale: int, maps) -> Pos:
    v = nearby_vectors(scale)
    if scale == 2 and _add(c, v[3]) not in maps[scale] and _add(c, (1, 1)) in maps[scale]:
        return _add(c, (1, 1))
    return _add(c, v[3])


def get_down_right(c: Pos, scale: int, maps) -> Pos:
    v = nearby_vectors(scale)
    if scale == 2 and _add(c, v[3]) not in maps[scale] and _add(c, (1, 1)) in maps[scale]:
        return _add(_add(c, (1, 1)), v[1])
    return _add(c, v[2])


def get_up_right(c: Pos, scale: int, maps) -> Pos:
    v = nearby_vectors(scale)
    if scale == 2 and _add(c, v[0]) not in maps[scale] and _add(c, (-1, -1)) in maps[scale]:
        return _add(c, (-1, -1))
    return _add(c, v[0])


def get_up_left(c: Pos, scale: int, maps) -> Pos:
    v = nearby_vectors(scale)
    if scale == 2 and _add(c, v[0]) not in maps[scale] and _add(c, (-1, -1)) in maps[scale]:
        return _add(_add(c, (-1, -1)), v[4])
    return _add(c, v[5])


def tree_offsets(depth: int) -> np.ndarray:
    """Per-node displacement from tile center, [2**(depth+1), 2] int32.

    Unfolds the binary tree: off[0] = off[1] = 0; off[2p] = off[p];
    off[2p+1] = off[p] + LITERALS[depth - level - 1]
    (reference wavelet_transform.rs:44-54). Shared by every tile.
    """
    n = 1 << (depth + 1)
    off = np.zeros((n, 2), dtype=np.int64)
    for level in range(depth):
        lo, hi = 1 << level, 1 << (level + 1)
        lit = np.asarray(LITERALS[depth - level - 1], dtype=np.int64)
        off[2 * lo : 2 * hi : 2] = off[lo:hi]
        off[2 * lo + 1 : 2 * hi : 2] = off[lo:hi] + lit
    return off


def fractal_divide(width: int, height: int, depth: int) -> List[Pos]:
    """BFS over the 6-neighbour tile lattice from the image center.

    Returns candidate tile centers before the any-in-bounds-leaf retention
    filter. Reference wavelet_transform.rs:450-484, with one fix: the
    reference stops expanding at out-of-bounds centers (keeping them only
    as a boundary ring), which under-covers images whose aspect ratio is
    extreme relative to the tile diameter (e.g. 2x511 at depth 9) — pixels
    in tiles only reachable *through* out-of-bounds centers are silently
    dropped there. Here the BFS expands every lattice center inside the
    image rectangle dilated by the maximum leaf-offset + neighbour-step
    radius, which contains every tile owning an in-bounds leaf (leaf
    positions are within max|offset| of the center) and every lattice path
    between such tiles. The kept set after retention is exactly {tiles
    with >= 1 in-bounds leaf} — identical to the reference whenever the
    reference's coverage is complete (geometry asserts coverage either way).
    """
    vecs = nearby_vectors(depth)
    off = tree_offsets(depth)
    n = 1 << depth
    radius = int(np.abs(off[n : 2 * n]).max()) + max(
        max(abs(v[0]), abs(v[1])) for v in vecs
    )
    lo_x, hi_x = -radius, width + radius
    lo_y, hi_y = -radius, height + radius
    start = (width // 2, height // 2)
    from collections import deque

    to_add = deque([start])
    queued = {start}
    out: List[Pos] = []
    while to_add:
        pos = to_add.popleft()
        out.append(pos)
        for v in vecs:
            nb = _add(pos, v)
            if nb in queued:
                continue
            if nb[0] < lo_x or nb[0] > hi_x or nb[1] < lo_y or nb[1] > hi_y:
                continue
            queued.add(nb)
            to_add.append(nb)
    return out


@dataclasses.dataclass
class FractalGeometry:
    """All static geometry for one (height, width, depth)."""

    height: int
    width: int
    depth: int
    num_tiles: int  # kept tiles T
    centers: np.ndarray  # [T, 2] int32, canonical (im, re) order
    offsets: np.ndarray  # [2**(depth+1), 2] int32 tree offsets
    pixel_gather: np.ndarray  # [T, 2**depth] int32 flat pixel index or -1 (leaf j)
    coef_mask: np.ndarray  # [T, 2**depth] bool: coefficient present (Some)
    nbr_idx: np.ndarray  # [T * 2**depth, 6] int32 neighbour value indices, -1 absent
    # Level-parallel variant: all six directional neighbours read at the
    # PARENT haar slot (fully decoded when a level starts), so a whole
    # level is one decode wave — the array-first context model ("parallel"
    # mode; the reference's causal same-level taps are kept as "parity"
    # mode via nbr_idx).
    nbr_par: np.ndarray  # [T * 2**depth, 6] int32, -1 absent
    level_of_haar: np.ndarray  # [2**depth] int32: 0 for haar 0/1, else floor(log2(haar))
    # Per-level canonical position lists as flat coef indices:
    level_slots: List[np.ndarray]  # level L in [0, depth): [n_L] int32
    # Tile-lattice neighbours for the two level-0 phases, all 6 directions
    # (left, up_left, up_right, right, down_left, down_right); the causal
    # trio is columns 0:3:
    tile_nbr: np.ndarray  # [T, 6] int32 tile index or -1

    @property
    def nodes_per_tile(self) -> int:
        return 1 << self.depth

    @property
    def num_coef_slots(self) -> int:
        return self.num_tiles * self.nodes_per_tile


def build_geometry(height: int, width: int, depth: int = BASE_FRAC_DEPTH) -> FractalGeometry:
    if height <= 0 or width <= 0:
        raise ValueError("empty image")
    n = 1 << depth
    off = tree_offsets(depth)

    candidates = fractal_divide(width, height, depth)
    cand = np.asarray(candidates, dtype=np.int64)  # [C, 2]

    # Leaf image positions per candidate tile: centers[:, None] + off[n:2n].
    leaf_pos = cand[:, None, :] + off[None, n : 2 * n, :]  # [C, n, 2]
    inb = (
        (leaf_pos[..., 0] >= 0)
        & (leaf_pos[..., 0] < width)
        & (leaf_pos[..., 1] >= 0)
        & (leaf_pos[..., 1] < height)
    )  # [C, n]

    # Retention: keep tiles whose root coefficient is Some == any in-bounds
    # leaf (reference retain at wavelet_transform.rs:415-416).
    keep = inb.any(axis=1)
    cand = cand[keep]
    leaf_pos = leaf_pos[keep]
    inb = inb[keep]

    # Canonical raster order by (im, re).
    order = np.lexsort((cand[:, 0], cand[:, 1]))
    centers = cand[order]
    leaf_pos = leaf_pos[order]
    inb = inb[order]
    T = centers.shape[0]

    # Pixel coverage must be an exact partition of the image.
    pix_flat = leaf_pos[..., 1] * width + leaf_pos[..., 0]
    pixel_gather = np.where(inb, pix_flat, -1).astype(np.int64)
    covered = pixel_gather[pixel_gather >= 0]
    if covered.size != height * width or np.unique(covered).size != height * width:
        raise AssertionError(
            f"tile leaves do not partition the {height}x{width} image: "
            f"{covered.size} in-bounds leaves, {np.unique(covered).size} unique"
        )

    # Coefficient presence masks, bottom-up (try_apply Some-propagation,
    # wavelet_transform.rs:14-26,179-225): node p has a coefficient iff any
    # in-bounds leaf lies under it; coef[0] mirrors node 1.
    mask = np.zeros((T, n), dtype=bool)
    half = n // 2
    # leaf-parent nodes p in [n/2, n): children are leaves 2p, 2p+1 -> leaf ids 2p-n, 2p+1-n
    mask[:, half:] = inb[:, 0::2] | inb[:, 1::2]
    for level in range(depth - 2, -1, -1):
        lo, hi = 1 << level, 1 << (level + 1)
        mask[:, lo:hi] = mask[:, 2 * lo : 2 * hi : 2] | mask[:, 2 * lo + 1 : 2 * hi : 2]
    mask[:, 0] = mask[:, 1]

    # Global position maps: per level, position -> (tile, haar). Levels use
    # haar indices [2**L, 2**(L+1)) (reference position_map semantics,
    # wavelet_transform.rs:47-54,434-448).
    maps: List[Dict[Pos, Tuple[int, int]]] = [dict() for _ in range(depth)]
    centers_list = [tuple(c) for c in centers]
    for L in range(depth):
        lo, hi = 1 << L, 1 << (L + 1)
        level_off = off[lo:hi]
        m = maps[L]
        for t in range(T):
            cx, cy = centers_list[t]
            for j in range(hi - lo):
                p = (cx + int(level_off[j, 0]), cy + int(level_off[j, 1]))
                if p in m:
                    raise AssertionError(f"position collision at level {L}: {p}")
                m[p] = (t, lo + j)

    tile_index = {c: t for t, c in enumerate(centers_list)}

    # Tile-level neighbours for the two level-0 phases: value = neighbour
    # tile's coefficient[phase] found via get_containing_fractal over the
    # 6-neighbour ring (prediction.rs:86-132 with position_map[0] only
    # containing each tile's own center). All 6 directions; the causal
    # trio used by parity mode is columns 0:3.
    tile_nbr = np.full((T, 6), -1, dtype=np.int64)
    all_getters = (
        get_left,
        get_up_left,
        get_up_right,
        get_right,
        get_down_left,
        get_down_right,
    )
    for t, c in enumerate(centers_list):
        for k, getter in enumerate(all_getters):
            p = getter(c, depth, maps)
            u = tile_index.get(p, -1)
            tile_nbr[t, k] = u

    # Per-level canonical slot lists and the 6-neighbour value index tensor.
    # nbr_idx[flat, 0:3] = same-level {left, up_left, up_right} coefficient
    # slots; nbr_idx[flat, 3:6] = {right, down_left, down_right} neighbours'
    # *parent* coefficient slots (context_modeling.rs:25-77: above-level
    # values are read at haar_pos/2 so decode stays causal).
    nbr_idx = np.full((T * n, 6), -1, dtype=np.int64)
    nbr_par = np.full((T * n, 6), -1, dtype=np.int64)
    level_slots: List[np.ndarray] = []

    # Level 0: canonical tile order; flat slot = t*n + 0 (DC phase uses +0,
    # root phase +1 — the schedule adds the phase offset).
    level_slots.append((np.arange(T, dtype=np.int64) * n).astype(np.int64))

    same_getters = (get_left, get_up_left, get_up_right)
    above_getters = (get_right, get_down_left, get_down_right)

    for L in range(1, depth):
        lo, hi = 1 << L, 1 << (L + 1)
        scale = depth - L
        m = maps[L]
        # canonical order of all level-L positions by (im, re)
        positions = []  # (im, re, t, haar)
        for p, (t, q) in m.items():
            positions.append((p[1], p[0], t, q))
        positions.sort()
        slots = np.asarray([t * n + q for (_, _, t, q) in positions], dtype=np.int64)
        level_slots.append(slots)

        for (py, px, t, q) in positions:
            flat = t * n + q
            X = (px, py)
            for k, getter in enumerate(same_getters):
                p2 = getter(X, scale, maps)
                hit = m.get(p2)
                if hit is not None:
                    u, q2 = hit
                    nbr_idx[flat, k] = u * n + q2
                    nbr_par[flat, k] = u * n + q2 // 2
            for k, getter in enumerate(above_getters):
                p2 = getter(X, scale, maps)
                hit = m.get(p2)
                if hit is not None:
                    u, q2 = hit
                    nbr_idx[flat, 3 + k] = u * n + q2 // 2
                    nbr_par[flat, 3 + k] = u * n + q2 // 2

    level_of_haar = np.zeros(n, dtype=np.int64)
    level_of_haar[1:] = np.floor(np.log2(np.arange(1, n))).astype(np.int64)
    level_of_haar[0] = 0

    return FractalGeometry(
        height=height,
        width=width,
        depth=depth,
        num_tiles=T,
        centers=centers.astype(np.int32),
        offsets=off.astype(np.int32),
        pixel_gather=pixel_gather.astype(np.int32),
        coef_mask=mask,
        nbr_idx=nbr_idx.astype(np.int32),
        nbr_par=nbr_par.astype(np.int32),
        level_of_haar=level_of_haar.astype(np.int32),
        level_slots=[s.astype(np.int32) for s in level_slots],
        tile_nbr=tile_nbr.astype(np.int32),
    )


_geometry_cache: Dict[Tuple[int, int, int], FractalGeometry] = {}
_cache_lock = threading.Lock()


def get_geometry(height: int, width: int, depth: int = BASE_FRAC_DEPTH) -> FractalGeometry:
    """Cached geometry per (h, w, depth) — the init()-analog of the codec
    (SURVEY.md section 3.5): everything downstream is a pure function of it.

    Uses the vectorized builder (frave_tpu/fractal/geometry_fast.py);
    `build_geometry` above is the loop-based definition it is
    differentially tested against."""
    key = (height, width, depth)
    with _cache_lock:
        geo = _geometry_cache.get(key)
    if geo is None:
        from ..native import build_geometry_native

        geo = build_geometry_native(height, width, depth)
        if geo is None:
            from .geometry_fast import build_geometry_fast

            geo = build_geometry_fast(height, width, depth)
        with _cache_lock:
            _geometry_cache[key] = geo
    return geo
