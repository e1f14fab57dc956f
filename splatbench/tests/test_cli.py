"""The command without a card, and alone in a directory without the port:
it exits non-zero and prints no result."""
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def _run(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "splatbench.run", "--workload",
         "trained262k.train", "--seed", str(2**31 + 11), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert "metrics" not in out.stdout and out.stdout.strip() == ""


def test_alone_without_the_port(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "splatbench"), tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "splatbench.run", "--workload",
         "trained262k.train", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
