"""Without a CUDA card a run fails and prints no result."""

from __future__ import annotations

import shutil
import subprocess
import sys

from conftest import REPO


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "packed-s222",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=cwd, timeout=300)


def test_no_card_no_result(card_absent):
    out = _run(REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder
    lacks the program: no result, whatever the machine."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
