"""Tests of the benchmark itself, on the CPU: `python3 -m pytest
port_bench/tests -m 'not card'`.  Tests marked `card` need a CUDA card and
skip without one: `python3 -m pytest port_bench/tests -m card` on the
card's machine."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_manifest() -> dict:
    """The benchmark's manifest with two cells at the CPU test size: the
    `tiny` sizes (ring 2^8, d 8), no bootstrap, inputs on the whole chain."""
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    man["configs"] = [
        {"name": f"tiny.{k}", "file": f"port_bench/tests/data/tiny.{k}.json"}
        for k in ("packed", "pertoken")]
    man["workloads"] = [
        {"name": f"t-{k}", "config": f"tiny.{k}", "traffic": "closed-s8",
         "chips": 1} for k in ("packed", "pertoken")]
    for m in man["per_layer"]:
        m["workloads"] = ["t-packed", "t-pertoken"]
    return man


def tiny_cell(kind: str):
    from port_bench import harness
    return harness.Cell(f"t-{kind}", tiny_manifest(), traffic_dir=DATA)


@pytest.fixture
def card_absent():
    """Skips the test when a CUDA card is present."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
