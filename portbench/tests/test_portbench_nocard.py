"""The command fails, printing no result, where there is no card, and
where the checkout holds only the benchmark's own files."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from portbench_tiny import ROOT

ARGS = ["-m", "portbench.run", "--workload", "al1d_200k.live_b1", "--seed",
        "3000000019", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable] + ARGS, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "needs 1 CUDA device" in p.stderr


def test_benchmark_files_alone_fail(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from portbench.run import execute; "
            "execute('al1d_200k.live_b1', 1, 1.0, False, 'cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "aline_tpu_torch" in p.stderr
