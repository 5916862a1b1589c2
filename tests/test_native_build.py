"""The native library builds on first use (frave_tpu/native.py): test
workers that start together must all end up with the library, also when
an older build of changed sources is on disk."""

import importlib.util
import multiprocessing
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _loads(root):
    spec = importlib.util.spec_from_file_location(
        "native_copy", os.path.join(root, "pkg", "native.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_lib() is not None


def test_concurrent_first_use_over_a_stale_build(tmp_path):
    shutil.copytree(
        os.path.join(REPO, "csrc"), tmp_path / "csrc",
        ignore=shutil.ignore_patterns("*.lock"),
    )
    os.makedirs(tmp_path / "pkg")
    shutil.copy(os.path.join(REPO, "frave_tpu", "native.py"), tmp_path / "pkg")
    with open(tmp_path / "csrc" / "refbase.cpp", "a") as f:
        f.write("// changed source: any build on disk is stale\n")
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        assert pool.map(_loads, [str(tmp_path)] * 4, chunksize=1) == [True] * 4
