"""run.py needs a card: without one, or in a directory that holds only
the benchmark's files, it exits with another code than 0 and prints no
result; it never falls back to the CPU.  The gpu-marked test runs on the
card only."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gpubench import cells


def _run(root, cwd):
    return subprocess.run(
        [sys.executable, os.path.join(root, "gpubench", "run.py"), "--workload",
         "n1092.boot8", "--seed", "2147483653", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(cells.ROOT, cells.ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """BENCHMARK.json and gpubench/ without the program."""
    shutil.copy(os.path.join(cells.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), str(tmp_path))
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.gpu
def test_generator_repeats_on_the_card(cuda, tmp_path):
    from gpubench.gen import lowcov

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    for p in (a, b):
        lowcov.write_gp(p, 10000, 64, (2.0, 6.0), 0.01, 2**31 + 7, cuda)
    assert np.fromfile(a).tobytes() == np.fromfile(b).tobytes()


@pytest.mark.gpu
def test_run_on_the_card(cuda):
    """A short run of the smallest cell on the card: a result, correct."""
    out = subprocess.run(
        [sys.executable, os.path.join(cells.ROOT, "gpubench", "run.py"), "--workload",
         "n1092.boot8", "--seed", "2147483659", "--seconds", "12", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=cells.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
