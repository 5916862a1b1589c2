"""REAL multi-process jax.distributed test (VERDICT round-1 item 6).

Spawns two OS processes that form an actual jax.distributed cluster over a
localhost coordinator (CPU backend), then run CorpusRunner with its
process identity taken from the live jax runtime — no simulated process
ids. The merged manifest must cover the whole corpus and every encoded
container must decode bit-exactly.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_WORKER = r"""
import json, os, sys, time
import jax
jax.config.update("jax_platforms", "cpu")

from frave_tpu.parallel.multihost import CorpusRunner, init_distributed

coord, nproc, pid, corpus_dir, out_dir = sys.argv[1:6]
t0 = time.perf_counter()
idx = init_distributed(coord, int(nproc), int(pid))
assert jax.process_count() == int(nproc), jax.process_count()
assert jax.process_index() == int(pid), jax.process_index()

files = sorted(str(p) for p in __import__("pathlib").Path(corpus_dir).glob("*.png"))
runner = CorpusRunner(output_dir=out_dir, batch_size=4)
assert runner.num_processes == int(nproc)  # picked up from live jax
assert runner.process_id == int(pid)
t1 = time.perf_counter()
manifest = runner.run(files)
t2 = time.perf_counter()
done = [k for k, e in manifest["entries"].items() if e["status"] == "done"]
print(json.dumps({"pid": int(pid), "init_s": t1 - t0, "run_s": t2 - t1,
                  "done": len(done)}))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_jax_distributed(tmp_path):
    corpus = tmp_path / "corpus"
    out = tmp_path / "out"
    corpus.mkdir()
    from PIL import Image

    rng = np.random.default_rng(5)
    n_files = 6
    arrays = {}
    for i in range(n_files):
        arr = rng.integers(0, 256, size=(32, 32), dtype=np.uint8)
        name = f"img{i}.png"
        Image.fromarray(arr, mode="L").save(corpus / name)
        arrays[name] = arr[:, :, None]

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    coord = f"localhost:{_free_port()}"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, "2", str(pid), str(corpus), str(out)],
            env=env,
            cwd=repo,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    results = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker failed:\n{stderr[-3000:]}"
        results.append(json.loads(stdout.strip().splitlines()[-1]))

    # both processes participated, the shard split covered the corpus
    assert {r["pid"] for r in results} == {0, 1}
    assert sum(r["done"] for r in results) == n_files
    assert all(r["done"] == n_files // 2 for r in results)

    from frave_tpu.parallel.multihost import merged_manifest

    merged = merged_manifest(str(out))
    assert merged["num_done"] == n_files
    assert merged["num_failed"] == 0
    assert sorted(merged["hosts"]) == [0, 1]

    # every container decodes bit-exactly (host-gathered outputs)
    from frave_tpu.codec.decoder import FRIDecoder

    dec = FRIDecoder(backend="numpy")
    for name, arr in arrays.items():
        blob = (out / (Path(name).stem + ".frv")).read_bytes()
        np.testing.assert_array_equal(dec.decode(blob).data, arr)
