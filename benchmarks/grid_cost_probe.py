"""Isolate the grid-mode decode cost components on the live device:

  (a) scan floor — R rows of the bare compare-free rANS body at
      [C, NL] with in-body one-hot bucket expansion (what the dense
      grid decode pays per row, no taps/scatters);
  (b) bulk tap + context math for every wave on dummy value grids
      (what the dense decode pays once per wave);
  (c) the per-wave coefficient scatter.

    python benchmarks/grid_cost_probe.py [--size 2048] [--ch 3]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=2048)
    ap.add_argument("--ch", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from frave_tpu.codec.grid_decode import (
        _WaveDev,
        _broadcast_parent,
        _shift2,
    )
    from frave_tpu.codec.pipeline_jax import _PACK_ZERO, _unpack3
    from frave_tpu.entropy.tables import CONTEXT_AMOUNT
    from frave_tpu.fractal.geometry import get_geometry
    from frave_tpu.fractal.lattice import build_wave_plans, get_lattice_grids
    from frave_tpu.fractal.schedule import (
        default_num_lanes,
        get_schedule,
    )
    from frave_tpu.ops import jax_ops as J
    from frave_tpu.ops.rans_jax import (
        decode_step_comparefree,
        prepare_compare_tables,
    )

    h = w = args.size
    C = args.ch
    geo = get_geometry(h, w)
    sched = get_schedule(h, w, mode="grid")
    nl = default_num_lanes(sched.num_symbols)
    lg = get_lattice_grids(h, w)
    plans = build_wave_plans(geo, lg)
    n_slots = geo.num_coef_slots
    waves = [_WaveDev(wp, nl, n_slots) for wp in plans]
    R = sum(wd.rows for wd in waves)
    print(f"{h}x{w}x{C}: nl={nl} rows={R} waves={len(waves)}")

    rng = np.random.default_rng(0)
    packed = C == 3
    fill = _PACK_ZERO if packed else 0

    # --- (a) scan floor
    cdfs = jnp.asarray(
        np.cumsum(rng.integers(0, 8, (C, CONTEXT_AMOUNT, 1024)), -1)
        % (1 << 14),
        jnp.int32,
    )
    bits = jnp.full((C, CONTEXT_AMOUNT), 14, jnp.int32)
    tabs = prepare_compare_tables(cdfs, bits)
    bk = jnp.asarray(
        rng.integers(0, CONTEXT_AMOUNT, (R, C, nl)), jnp.int32
    )
    act = jnp.asarray(rng.random((R, nl)) < 0.7)
    stream = jnp.zeros((1 << 22,), jnp.uint16)
    x0 = jnp.full((C, nl), 1 << 16, jnp.uint32)
    iota_ca = jnp.arange(CONTEXT_AMOUNT, dtype=jnp.int32)

    @jax.jit
    def scan_only(x0, bk, act):
        def body(carry, xs):
            x, gptr = carry
            bk_t, act_t = xs
            oh = jnp.asarray(bk_t[..., None] == iota_ca, jnp.bfloat16)
            sym, x, gptr = decode_step_comparefree(
                x, gptr, oh, act_t, stream, tabs
            )
            return (x, gptr), sym[0, 0]

        (x, g), s = jax.lax.scan(body, (x0, jnp.int32(0)), (bk, act))
        return x, s.sum()

    scan_only(x0, bk, act)[1].block_until_ready()
    t = 1e9
    for _ in range(args.reps):
        t0 = time.perf_counter()
        scan_only(x0, bk, act)[1].block_until_ready()
        t = min(t, time.perf_counter() - t0)
    print(
        json.dumps(
            {"scan_floor_s": round(t, 3), "ms_per_row": round(1e3 * t / R, 3)}
        )
    )

    # --- (b) bulk taps + contexts per wave (dummy grids)
    vparams = jnp.asarray(rng.normal(0, 0.2, (C, sched.num_fine, 6)), jnp.float32)
    wparams = jnp.asarray(rng.normal(0, 0.2, (C, sched.num_fine, 6)), jnp.float32)
    gdtype = jnp.uint32 if packed else jnp.int16

    from frave_tpu.codec.grid_decode import (
        _pack_tap_vals,
        _plane_contexts,
        _tap_planes,
    )

    def parent_of(wd):
        return (
            jnp.full(wd.shape, _PACK_ZERO, jnp.uint32)
            if packed
            else jnp.zeros((C,) + wd.shape, jnp.int16)
        )

    def planes_of(wd, parent):
        pv = _broadcast_parent(wd.wp, parent, fill, gdtype)
        return _tap_planes(wd, pv, parent, packed, C, fill)

    def bulk(stage):
        """stage selects how much of the per-wave bulk work runs:
        'planes' = broadcast + shifted tap planes only;
        'pack'   = + the [kw, 6] pack gather + packed contexts;
        'plane_ctx' = + on-grid contexts + [kw] x2 pack gathers."""

        def fn():
            tot = jnp.float32(0)
            parent = parent_of(waves[2])
            for wd in waves[3:]:
                planes = planes_of(wd, parent)
                if stage == "planes":
                    tot = tot + sum(
                        p.astype(jnp.float32).sum() for p in planes
                    )
                elif stage == "pack":
                    vals = _pack_tap_vals(wd, planes, packed, C)
                    bk_, pr_ = J.contexts_static(
                        vals,
                        vparams[:, wd.group].reshape(C, 1, 6),
                        wparams[:, wd.group].reshape(C, 1, 6),
                        False,
                    )
                    tot = tot + bk_.sum() + pr_.sum()
                else:
                    bk_, pr_ = _plane_contexts(
                        wd, planes, vparams, wparams, packed, C
                    )
                    tot = tot + bk_.sum() + pr_.sum()
                parent = parent_of(wd)
            return tot

        f = jax.jit(fn)
        f().block_until_ready()
        t = 1e9
        for _ in range(args.reps):
            t0 = time.perf_counter()
            f().block_until_ready()
            t = min(t, time.perf_counter() - t0)
        return t

    for stage in ("planes", "pack", "plane_ctx"):
        print(json.dumps({f"bulk_{stage}_s": round(bulk(stage), 3)}))

    # --- (c) per-wave scatters
    def scatters():
        if packed:
            qpad = jnp.full((n_slots + 1,), _PACK_ZERO, jnp.uint32)
            for wd in waves:
                v = jnp.full((wd.kw,), _PACK_ZERO, jnp.uint32)
                qpad = qpad.at[wd.wslot].set(v)
            return qpad.sum()
        qpad = jnp.zeros((C, n_slots + 1), jnp.int16)
        for wd in waves:
            v = jnp.zeros((C, wd.kw), jnp.int16)
            qpad = jax.vmap(lambda q, vv: q.at[wd.wslot].set(vv))(qpad, v)
        return qpad.sum()

    def to_grids():
        tot = jnp.uint32(0) if packed else jnp.int32(0)
        for wd in waves:
            if packed:
                flat = jnp.full((wd.cells,), _PACK_ZERO, jnp.uint32)
                g2 = flat.at[wd.pack_idx].set(
                    jnp.zeros((wd.kw,), jnp.uint32), unique_indices=True
                )
            else:
                flat = jnp.zeros((C, wd.cells), jnp.int16)
                g2 = flat.at[:, wd.pack_idx].set(
                    jnp.zeros((C, wd.kw), jnp.int16), unique_indices=True
                )
            tot = tot + g2.sum()
        return tot

    for name, fn in (("scatters", scatters), ("to_grids", to_grids)):
        g = jax.jit(fn)
        g().block_until_ready()
        t = 1e9
        for _ in range(args.reps):
            t0 = time.perf_counter()
            g().block_until_ready()
            t = min(t, time.perf_counter() - t0)
        print(json.dumps({f"{name}_s": round(t, 3)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
