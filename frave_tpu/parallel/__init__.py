"""Multi-chip / multi-host parallelism (SURVEY.md section 2.3).

The reference is single-threaded Rust with zero parallelism; every
capability here is new:

  * dp   — batch-of-images sharded over a `dp` mesh axis (config 4)
  * tp   — fractal tiles + schedule slices + rANS lanes of one image
           sharded over a `tp` mesh axis (config 3); shared context
           tables / Gram matrices reduced with `psum`, cross-tile
           neighbour context satisfied by a halo exchange of the
           coefficient plane between devices
  * sp   — the level-synchronous decode wavefront (the long-context
           analog): lanes sharded over devices, coefficient plane
           rebuilt per step with a lax collective
  * ep   — the 10 rANS context buckets route symbols to frequency
           tables on each device (segment-sum dispatch), never across
  * multi-host — `jax.distributed` init + per-host corpus shards with a
           host-side bitstream gather (frave_tpu/parallel/multihost.py)
"""

from .mesh import make_mesh, mesh_factorization
from .sharded import ShardedDecoder, ShardedEncoder

__all__ = ["make_mesh", "mesh_factorization", "ShardedEncoder", "ShardedDecoder"]
