"""Multi-host orchestration: distributed init, corpus sharding,
checkpoint/resume, host-side bitstream gather.

The reference has no notion of any of this (SURVEY.md section 2.3/5:
single process, CLI panics on errors, no resume). This module supplies
the multi-host layer (BASELINE.json config 5):

  * `init_distributed` wraps jax.distributed.initialize (the network
    between hosts carries orchestration only — entropy-coded bytes are
    host data, SURVEY.md section 5);
  * `CorpusRunner` shards a corpus of images across hosts (deterministic
    round-robin by process index), encodes shape-bucketed batches through
    the single-device fused pipeline, and writes per-image .frv files — the
    host-side bitstream mux of the north star;
  * progress is checkpointed to a per-host JSON manifest after every
    batch (atomic tmp+rename), so a killed run resumes where it stopped —
    the elastic-recovery obligation; failed images are retried once and
    then recorded as failed instead of killing the run (the reference CLI
    panics, encode.rs:19-21);
  * `merged_manifest` gathers per-host manifests for corpus-level stats.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize jax.distributed if a multi-process setup is requested
    (explicitly or via JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID env). Returns the process index (0 when single-host).

    The layout is one process per host, driving all of that host's
    devices: no `local_device_ids` is passed, so each process sees every
    local GPU. A process per GPU on one host is not supported — every
    process would claim every card."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address and num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id or 0,
        )
        return jax.process_index()
    return 0


@dataclasses.dataclass
class CorpusRunner:
    """Shard-encode a corpus with checkpoint/resume.

    num_processes/process_id default to the live jax values but can be
    passed explicitly (used by tests to simulate hosts without a real
    multi-process setup)."""

    output_dir: str
    manifest_dir: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    batch_size: int = 8
    max_retries: int = 1
    # BASELINE.json config 5 composition: when a jax.sharding.Mesh with
    # ("dp", "tp") axes is supplied, each host drives the dp x tp
    # ShardedEncoder (parallel/sharded.py — boundary-residue ppermute
    # halo and all) over its shard instead of the single-chip fused
    # pipeline. One compiled encoder is cached per image shape.
    mesh: Optional[object] = None

    def __post_init__(self):
        if self.num_processes is None or self.process_id is None:
            try:
                import jax

                self.num_processes = self.num_processes or jax.process_count()
                self.process_id = (
                    self.process_id
                    if self.process_id is not None
                    else jax.process_index()
                )
            except Exception:
                self.num_processes = self.num_processes or 1
                self.process_id = self.process_id or 0
        self.manifest_dir = self.manifest_dir or self.output_dir
        Path(self.output_dir).mkdir(parents=True, exist_ok=True)
        Path(self.manifest_dir).mkdir(parents=True, exist_ok=True)
        self._sharded_cache: Dict[tuple, object] = {}

    # ---------------- sharded (dp x tp) encode ----------------
    def _encode_sharded(self, imgs, opts) -> List[bytes]:
        """Encode one shape bucket through the dp x tp ShardedEncoder.
        The encoder is compiled for a fixed global batch B (a multiple of
        the mesh's dp extent); short chunks are padded by repeating the
        first image and the padded outputs dropped."""
        import numpy as np

        from .sharded import ShardedEncoder

        h, w, c = imgs[0].data.shape
        dp = self.mesh.shape["dp"]
        B = -(-max(self.batch_size, 1) // dp) * dp
        key = (h, w, c, B, opts.mode)
        enc = self._sharded_cache.get(key)
        if enc is None:
            enc = ShardedEncoder(
                height=h,
                width=w,
                channels=c,
                batch=B,
                mesh=self.mesh,
                mode=opts.mode,
            )
            self._sharded_cache[key] = enc
        out: List[bytes] = []
        for i in range(0, len(imgs), B):
            chunk = imgs[i : i + B]
            n = len(chunk)
            arrs = [im.data for im in chunk]
            while len(arrs) < B:
                arrs.append(arrs[0])
            out.extend(enc.encode_batch(np.stack(arrs), opts)[:n])
        return out

    # ---------------- manifest ----------------
    @property
    def manifest_path(self) -> Path:
        return Path(self.manifest_dir) / f"manifest_host{self.process_id}.json"

    def _load_manifest(self) -> Dict:
        p = self.manifest_path
        if p.exists():
            try:
                return json.loads(p.read_text())
            except (OSError, json.JSONDecodeError):
                pass
        return {"host": self.process_id, "entries": {}}

    def _save_manifest(self, manifest: Dict) -> None:
        p = self.manifest_path
        fd, tmp = tempfile.mkstemp(dir=str(p.parent), prefix=p.name)
        with os.fdopen(fd, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, p)  # atomic

    # ---------------- sharding ----------------
    def my_shard(self, files: Sequence[str]) -> List[str]:
        """Deterministic round-robin over the SORTED corpus so every host
        agrees on the assignment without communication."""
        ordered = sorted(str(f) for f in files)
        return ordered[self.process_id :: self.num_processes]

    # ---------------- run ----------------
    def run(self, files: Sequence[str], opts=None) -> Dict:
        """Encode this host's shard; returns the final manifest."""
        import numpy as np

        from ..codec.options import EncoderOptions
        from ..images import RasterImage
        from ..codec.container import serialize
        from ..codec.pipeline_jax import encode_pipeline_jax_batch

        opts = opts or EncoderOptions()
        manifest = self._load_manifest()
        entries = manifest["entries"]
        shard = [
            f
            for f in self.my_shard(files)
            if entries.get(f, {}).get("status") != "done"
        ]

        # bucket by (h, w, c) so batches share one compiled program
        def load(fp):
            from PIL import Image

            im = Image.open(fp)
            if im.mode == "L":
                return np.asarray(im)[:, :, None]
            return np.asarray(im.convert("RGB"))

        buckets: Dict[tuple, List[str]] = defaultdict(list)
        for fp in shard:
            try:
                arr = load(fp)
                buckets[arr.shape].append(fp)
            except Exception as e:
                entries[fp] = {"status": "failed", "error": f"read: {e}"}
        self._save_manifest(manifest)

        for shape, paths in sorted(buckets.items()):
            for i in range(0, len(paths), self.batch_size):
                chunk = paths[i : i + self.batch_size]
                imgs = [RasterImage.from_array(load(fp)) for fp in chunk]
                for attempt in range(self.max_retries + 1):
                    try:
                        if self.mesh is not None:
                            blobs = self._encode_sharded(imgs, opts)
                        else:
                            blobs = [
                                serialize(c)
                                for c in encode_pipeline_jax_batch(imgs, opts)
                            ]
                        break
                    except Exception as e:
                        if attempt >= self.max_retries:
                            for fp in chunk:
                                entries[fp] = {
                                    "status": "failed",
                                    "error": str(e),
                                }
                            blobs = None
                if blobs is None:
                    self._save_manifest(manifest)
                    continue
                for fp, blob, img in zip(chunk, blobs, imgs):
                    out = Path(self.output_dir) / (Path(fp).stem + ".frv")
                    out.write_bytes(blob)
                    entries[fp] = {
                        "status": "done",
                        "frif_bytes": len(blob),
                        "raw_bytes": int(img.data.size),
                        "output": str(out),
                        "ts": time.time(),
                    }
                self._save_manifest(manifest)
        return manifest


def merged_manifest(manifest_dir: str) -> Dict:
    """Host-side gather of all per-host manifests (corpus-level stats)."""
    merged: Dict = {"entries": {}, "hosts": []}
    for p in sorted(Path(manifest_dir).glob("manifest_host*.json")):
        m = json.loads(p.read_text())
        merged["hosts"].append(m.get("host"))
        merged["entries"].update(m.get("entries", {}))
    done = [e for e in merged["entries"].values() if e.get("status") == "done"]
    merged["num_done"] = len(done)
    merged["num_failed"] = len(merged["entries"]) - len(done)
    merged["total_raw_bytes"] = sum(e.get("raw_bytes", 0) for e in done)
    merged["total_frif_bytes"] = sum(e.get("frif_bytes", 0) for e in done)
    return merged
