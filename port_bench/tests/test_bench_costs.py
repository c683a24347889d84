"""The kernels' cost files against the bounds recorded for the port's
kernels at their main shapes."""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch
from conftest import BENCH

from port_bench import harness, roofline

PEAKS = json.loads((BENCH / "peaks.json").read_text())


def kernel(name):
    return harness.load_module(BENCH / "costs" / f"{name}.py")


def test_k1_at_4_79_2_15():
    k = kernel("ntt_fwd")
    x = torch.empty((4, 79, 1 << 15), dtype=torch.int32, device="meta")
    rec = k.record(x, None, tuple(range(79)))
    assert rec == {"n": 1 << 15, "rows": 316, "tables": 79}
    assert roofline.bound_s(k.cost(rec), PEAKS) * 1e3 == \
        pytest.approx(0.0309, abs=5e-5)


def test_k1_limb_map_counts_active_rows():
    k = kernel("ntt_fwd")
    x = torch.empty((3, 2, 4, 256), dtype=torch.int32, device="meta")
    lmap = ((0, 1, -1, 3), (-1, 1, 2, 3), (0, -1, 2, 3))
    assert k.record(x, None, lmap) == {"n": 256, "rows": 2 * 9, "tables": 4}


def test_k2_rows():
    k = kernel("ntt_inv")
    x = torch.empty((2, 8, 16, 1 << 15), dtype=torch.int32, device="meta")
    rec = k.record(x[..., 15:, :], None, (79,))
    assert rec == {"n": 1 << 15, "rows": 16, "tables": 1}


def test_k3_at_batch_4_59_to_3_x_79():
    k = kernel("base_convert")
    x = torch.empty((4, 59, 1 << 15), dtype=torch.int32, device="meta")
    bc = SimpleNamespace(nd=3, q_out=torch.empty(79))
    rec = k.record(x, bc, False)
    assert roofline.bound_s(k.cost(rec), PEAKS) * 1e3 == \
        pytest.approx(0.0463, abs=5e-5)
