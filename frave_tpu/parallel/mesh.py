"""Device mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def mesh_factorization(n: int) -> Tuple[int, int]:
    """Split n devices into (dp, tp): the largest power-of-two dp <= sqrt(n)
    that divides n, remainder to tp. The tile/lane axis gets the larger
    share because intra-image decode collectives run per scan step while
    dp never communicates. On GPUs joined all to all (NVLink) every pair
    of devices is equally close, so the split follows the algorithm
    alone; device order within the mesh does not matter."""
    dp = 1
    while dp * 2 <= n // (dp * 2) and n % (dp * 2) == 0:
        dp *= 2
    return dp, n // dp


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("dp", "tp"),
    shape: Optional[Tuple[int, int]] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    if shape is None:
        shape = mesh_factorization(n)
    assert shape[0] * shape[1] == n
    arr = np.array(devs[:n]).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))
