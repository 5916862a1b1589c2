"""Build the per-scan-step cost model for the decode wavefront on this
device: what does one lax.scan step actually cost as a function of the
number of chained ops, gather form, index count, and table size?

Variants (all S=128 steps, carry-dependent so steps serialize):
  empty        carry = x * 5 + 1 only (pure scan-step floor)
  g1           one batched gather [B,C,NL] idx into [B,C,NSLOT]
  g1_flat      same lookups, flat 1D operand + folded index
  g2           two chained batched gathers
  g3           three chained batched gathers
  g1_scatter   one gather + one scatter (production-like rhythm)
  g1_big       one batched gather into the 31MB merged table
  g1_small     one batched gather, NL=64 indices only

Run: python benchmarks/step_cost_model.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from frave_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import jax.numpy as jnp
import numpy as np

B, C, NL = 64, 1, 512
CA, LUT = 15, 1 << 12
NSLOT = 65536 + 1
S = 128


def timed(fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps / S * 1e3  # ms/step


def main():
    rng = np.random.default_rng(0)
    tab = jnp.asarray(rng.integers(0, NSLOT, (B, C, NSLOT), np.int32))
    big = jnp.asarray(
        rng.integers(0, NSLOT, (B, C, CA * LUT), np.int32)
    )
    x0 = jnp.asarray(rng.integers(0, NSLOT, (B, C, NL), np.int32))
    x0s = x0[..., :64]
    tflat = tab.reshape(-1)
    boff = (jnp.arange(B * C, dtype=jnp.int32) * NSLOT)[:, None]

    def scan_over(stepfn, x0, extra=None):
        def run(x0, *e):
            def stp(x, _):
                return stepfn(x, *e), None

            x, _ = jax.lax.scan(stp, x0, None, length=S)
            return x

        return timed(jax.jit(run), x0, *(extra or ()))

    res = {}
    res["empty"] = scan_over(lambda x: (x * 5 + 1) % NSLOT, x0)

    def g1(x, t):
        v = jax.vmap(jax.vmap(lambda tt, ii: tt[ii]))(t, x)
        return (v + x) % NSLOT

    res["g1"] = scan_over(g1, x0, (tab,))

    def g1f(x, t):
        idx = (boff + x.reshape(B * C, NL)).reshape(-1)
        v = t[idx].reshape(B, C, NL)
        return (v + x) % NSLOT

    res["g1_flat"] = scan_over(g1f, x0, (tflat,))

    def g2(x, t):
        v = jax.vmap(jax.vmap(lambda tt, ii: tt[ii]))(t, x)
        v2 = jax.vmap(jax.vmap(lambda tt, ii: tt[ii]))(t, (v + 1) % NSLOT)
        return (v2 + x) % NSLOT

    res["g2"] = scan_over(g2, x0, (tab,))

    def g3(x, t):
        v = x
        for _ in range(3):
            v = (
                jax.vmap(jax.vmap(lambda tt, ii: tt[ii]))(t, v) + 1
            ) % NSLOT
        return v

    res["g3"] = scan_over(g3, x0, (tab,))

    def g1s(x, t):
        def one(tt, ii):
            v = tt[ii]
            tt = tt.at[(ii + 7) % NSLOT].set(v + 1)
            return tt, v

        t, v = jax.vmap(jax.vmap(one))(t, x)
        return (v + x) % NSLOT

    # scatter needs the table in the carry
    def run_g1s(x0, t):
        def stp(carry, _):
            x, t = carry
            def one(tt, ii):
                v = tt[ii]
                tt = tt.at[(ii + 7) % NSLOT].set(v + 1)
                return tt, v
            t, v = jax.vmap(jax.vmap(one))(t, x)
            return ((v + x) % NSLOT, t), None

        (x, t), _ = jax.lax.scan(stp, (x0, t), None, length=S)
        return x

    res["g1_scatter"] = timed(jax.jit(run_g1s), x0, tab)

    def g1b(x, t):
        v = jax.vmap(jax.vmap(lambda tt, ii: tt[ii]))(
            t, x % (CA * LUT)
        )
        return (v + x) % NSLOT

    res["g1_big"] = scan_over(g1b, x0, (big,))

    def g1sm(x, t):
        v = jax.vmap(jax.vmap(lambda tt, ii: tt[ii]))(t, x)
        return (v + x) % NSLOT

    res["g1_small"] = scan_over(g1sm, x0s, (tab,))

    print(json.dumps({k: round(v, 3) for k, v in res.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
