"""ctypes bindings for the native host library (csrc/libfrave_host.so).

The native library accelerates host-side components whose reference
counterparts are native Rust (SURVEY.md section 2: the entire reference is
Rust): currently the fractal-geometry builder. Loading is best-effort —
every native entry point has a pure-Python fallback, so the package works
without a toolchain; `make -C csrc` enables it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
from typing import Optional

_CSRC_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "csrc")
)
_LIB_PATH = os.path.join(_CSRC_DIR, "build", "libfrave_host.so")
# keep in sync with csrc/Makefile's SRC_SHA (cat order matters)
_SRC_PATHS = (
    os.path.join(_CSRC_DIR, "geometry.cpp"),
    os.path.join(_CSRC_DIR, "geometry_core.h"),
    os.path.join(_CSRC_DIR, "refbase.cpp"),
    os.path.join(_CSRC_DIR, "frif.cpp"),
)

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _source_sha() -> Optional[str]:
    try:
        hsh = hashlib.sha256()
        for path in _SRC_PATHS:
            with open(path, "rb") as f:
                hsh.update(f.read())
        return hsh.hexdigest()
    except OSError:
        return None


def _try_load(expect_sha: Optional[str]) -> Optional[ctypes.CDLL]:
    """Load the shared library iff its baked-in source hash matches the
    on-disk source (a binary is never trusted over the sources it claims
    to be built from)."""
    if not os.path.exists(_LIB_PATH):
        return None
    if expect_sha is not None:
        # check the baked-in hash before loading: a process that has
        # loaded a stale library keeps getting it back from dlopen even
        # after the file is rebuilt
        with open(_LIB_PATH, "rb") as f:
            if expect_sha.encode("ascii") not in f.read():
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    try:
        lib.fg_source_sha.restype = ctypes.c_char_p
        built_sha = lib.fg_source_sha().decode("ascii")
    except AttributeError:
        return None  # pre-hash build: treat as stale
    if expect_sha is not None and built_sha != expect_sha:
        return None
    lib.fg_num_tiles.restype = ctypes.c_int64
    lib.fg_num_tiles.argtypes = [ctypes.c_int] * 3
    lib.fg_layer_waves.restype = ctypes.c_int
    lib.fg_layer_waves.argtypes = [
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.fg_build.restype = ctypes.c_int
    lib.fg_build.argtypes = [
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.rb_encode.restype = ctypes.c_int
    lib.rb_encode.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rb_decode.restype = ctypes.c_int
    lib.rb_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.rb_free.argtypes = [ctypes.c_void_p]
    lib.rb_use_cache.argtypes = [ctypes.c_int]
    # frif cross-implementation oracle (csrc/frif.cpp, round 5)
    lib.frif_probe.restype = ctypes.c_int
    lib.frif_probe.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.frif_decode.restype = ctypes.c_int
    lib.frif_decode.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.frif_encode.restype = ctypes.c_int
    lib.frif_encode.argtypes = [ctypes.c_int] * 3 + [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.frif_free.argtypes = [ctypes.c_void_p]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """Load the native library, building it from source on demand.

    The binary is not committed; this builds `make -C csrc` on first use
    (best-effort — missing toolchain falls back to the Python builders)
    and verifies the baked-in source hash so a stale build can never
    silently diverge from csrc/geometry.cpp."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    expect = _source_sha()
    _lib = _try_load(expect)
    if _lib is None and os.environ.get("FRAVE_NO_NATIVE_BUILD") != "1":
        # processes that start together (test workers) would otherwise
        # build over each other and load a half-written library: one
        # builds under the lock, the others wait and load its result
        try:
            os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
            with open(_LIB_PATH + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                _lib = _try_load(expect)
                if _lib is None:
                    subprocess.run(
                        ["make", "-C", _CSRC_DIR],
                        check=True,
                        capture_output=True,
                        timeout=120,
                    )
                    _lib = _try_load(expect)
        except (OSError, subprocess.SubprocessError):
            return None
    return _lib


def have_native() -> bool:
    return get_lib() is not None


def build_geometry_native(height: int, width: int, depth: int):
    """Native geometry build; returns a FractalGeometry or None if the
    library is unavailable (caller falls back to the numpy builder)."""
    lib = get_lib()
    if lib is None:
        return None

    import numpy as np

    from .fractal import geometry as G

    T = int(lib.fg_num_tiles(height, width, depth))
    if T < 0:
        raise ValueError(f"native geometry plan failed for {height}x{width}")
    n = 1 << depth

    centers = np.empty((T, 2), dtype=np.int32)
    pixel_gather = np.empty((T, n), dtype=np.int32)
    coef_mask = np.empty((T, n), dtype=np.uint8)
    nbr_idx = np.empty((T * n, 6), dtype=np.int32)
    nbr_par = np.empty((T * n, 6), dtype=np.int32)
    tile_nbr = np.empty((T, 6), dtype=np.int32)
    level_slots_flat = np.empty(T * n, dtype=np.int32)

    rc = lib.fg_build(
        height,
        width,
        depth,
        T,
        centers.ctypes.data,
        pixel_gather.ctypes.data,
        coef_mask.ctypes.data,
        nbr_idx.ctypes.data,
        nbr_par.ctypes.data,
        tile_nbr.ctypes.data,
        level_slots_flat.ctypes.data,
    )
    if rc != 0:
        raise AssertionError(f"native geometry build failed (rc={rc})")

    level_slots = []
    o = 0
    level_slots.append(level_slots_flat[o : o + T].copy())
    o += T
    for L in range(1, depth):
        cnt = T * (1 << L)
        level_slots.append(level_slots_flat[o : o + cnt].copy())
        o += cnt

    level_of_haar = np.zeros(n, dtype=np.int32)
    if n > 1:
        level_of_haar[1:] = np.floor(np.log2(np.arange(1, n))).astype(np.int32)

    off = G.tree_offsets(depth).astype(np.int32)
    return G.FractalGeometry(
        height=height,
        width=width,
        depth=depth,
        num_tiles=T,
        centers=centers,
        offsets=off,
        pixel_gather=pixel_gather,
        coef_mask=coef_mask.astype(bool),
        nbr_idx=nbr_idx,
        nbr_par=nbr_par,
        level_of_haar=level_of_haar,
        level_slots=level_slots,
        tile_nbr=tile_nbr,
    )


def refbase_roundtrip(image, cache_geometry: bool = False):
    """Single-thread C reference-baseline codec (csrc/refbase.cpp): the
    measured stand-in for the Rust CLI. Encodes + decodes
    `image` [H, W, C] uint8, asserts losslessness, returns
    (encode_seconds, decode_seconds, blob_bytes). cache_geometry=False
    rebuilds the tile lattice per call like the reference does
    (wavelet_transform.rs:405,392); True amortizes it (conservative,
    faster baseline). Returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import time

    import numpy as np

    img = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, c = img.shape
    lib.rb_use_cache(1 if cache_geometry else 0)
    blob = ctypes.c_void_p()
    blen = ctypes.c_int64()
    t0 = time.perf_counter()
    rc = lib.rb_encode(h, w, c, img.ctypes.data, ctypes.byref(blob), ctypes.byref(blen))
    t1 = time.perf_counter()
    if rc != 0:
        raise AssertionError(f"refbase encode failed (rc={rc})")
    try:
        out = np.empty((h, w, c), dtype=np.uint8)
        t2 = time.perf_counter()
        rc = lib.rb_decode(blob, blen.value, out.ctypes.data)
        t3 = time.perf_counter()
        if rc != 0:
            raise AssertionError(f"refbase decode failed (rc={rc})")
    finally:
        lib.rb_free(blob)
    if not np.array_equal(out, img):
        raise AssertionError("refbase baseline round trip is not lossless")
    return t1 - t0, t3 - t2, int(blen.value)


def layer_waves_native(deps):
    """Native Kahn longest-path layering; deps [n, 3] int32 (-1 absent).
    Returns int32 waves or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    d = np.ascontiguousarray(deps, dtype=np.int32)
    n = d.shape[0]
    assert d.shape == (n, 3)
    out = np.empty(n, dtype=np.int32)
    rc = lib.fg_layer_waves(n, d.ctypes.data, out.ctypes.data)
    if rc == 2:
        raise AssertionError("dependency id out of range in deps array")
    if rc != 0:
        raise AssertionError("cycle in causal dependency graph")
    return out


def frif_decode_native(blob: bytes):
    """Decode a frif v8/v9 mode="grid" container with the INDEPENDENT
    C++ implementation (csrc/frif.cpp — the cross-implementation format
    oracle, round 5). Returns an [h, w, C] uint8 array, or None when the
    native library is unavailable. Raises ValueError on parse/semantic
    errors (diagnostic rc in the message)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    buf = np.frombuffer(blob, dtype=np.uint8)
    h = ctypes.c_int()
    w = ctypes.c_int()
    c = ctypes.c_int()
    rc = lib.frif_probe(
        buf.ctypes.data, len(blob), ctypes.byref(h),
        ctypes.byref(w), ctypes.byref(c),
    )
    if rc != 0:
        raise ValueError(f"frif_probe failed (rc={rc})")
    out = np.empty((h.value, w.value, c.value), dtype=np.uint8)
    rc = lib.frif_decode(buf.ctypes.data, len(blob), out.ctypes.data)
    if rc != 0:
        raise ValueError(f"frif_decode failed (rc={rc})")
    return out


def frif_encode_native(
    pixels,
    quality: int = 3,
    transform: int = 0,
    num_lanes: int = 0,
    mode: str = "grid",
):
    """Encode [h, w, C] uint8 pixels into a frif v9 container
    (mode="grid" or "parallel") with the independent C++
    implementation. Returns bytes, or None when the native library is
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    arr = np.ascontiguousarray(pixels, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    blob_p = ctypes.c_void_p()
    blob_len = ctypes.c_int64()
    mode_enc = {"parallel": 0, "grid": 2}[mode]
    rc = lib.frif_encode(
        h, w, c, arr.ctypes.data, quality, transform, num_lanes,
        mode_enc, ctypes.byref(blob_p), ctypes.byref(blob_len),
    )
    if rc != 0:
        raise ValueError(f"frif_encode failed (rc={rc})")
    try:
        return ctypes.string_at(blob_p.value, blob_len.value)
    finally:
        lib.frif_free(blob_p)
