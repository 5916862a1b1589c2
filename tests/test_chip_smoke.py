"""chip_smoke.py on the CPU: it must refuse to run without a GPU (and
without the rest of the repo), and its phases, run here at small sizes,
must pass, so that the script's checks stay in step with the codec."""

import os
import shutil
import subprocess
import sys

import numpy as np

import chip_smoke
from bench import make_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_refuses_cpu_platform():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = _run(REPO, env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_fails_alone_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path, dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phases_pass_at_small_sizes():
    assert chip_smoke.phase_photo(make_corpus(1, 96, 64, 3, seed=0)[0])
    info = chip_smoke.phase_batch(make_corpus(6, 64, 48, 1, seed=1), 4, 3)
    assert info["images"] == 6
    assert chip_smoke.phase_golden(os.path.join(REPO, "tests", "data"))


def test_same_reports_mismatches():
    a = np.zeros((4, 4, 1), np.uint8)
    chip_smoke._same(a.copy(), a, "equal")
    b = a.copy()
    b[1, 2, 0] = 7
    for got in (b, None, a[:2]):
        try:
            chip_smoke._same(got, a, "bad")
        except AssertionError:
            continue
        raise AssertionError("mismatch not reported")


def test_multi_phase_passes_on_four_cpu_devices():
    import jax

    img = make_corpus(1, 128, 128, 3, seed=3)[0]
    info = chip_smoke.phase_multi(img, jax.devices()[:4])
    assert len(info["peak_bytes_in_use"]) == 4
