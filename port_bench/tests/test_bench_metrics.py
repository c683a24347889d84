"""The metric arithmetic on fixed records."""

from __future__ import annotations

import json
import math

import pytest
from conftest import BENCH

from port_bench import harness, roofline, trace

PEAKS = json.loads((BENCH / "peaks.json").read_text())


class Kernel:
    """A stand-in for a kernel's cost module (hashable, as modules are)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def reader(name):
    return harness.load_module(BENCH / "metrics" / f"{name}.py")


def test_end_to_end():
    run = {"requests": [{"s": s} for s in (1.0, 2.0, 3.0, 4.0)],
           "window_s": 10.5}
    got = harness.end_to_end(run, 33.0, 8_000_000_000, 2.0 ** -12)
    assert got["request_s"] == pytest.approx(10.5 / 4)
    # linear interpolation: 90% of the way from the 1st to the 4th value
    assert got["request_p90_s"] == pytest.approx(3.7)
    assert got["logit_bits"] == pytest.approx(12.0)
    assert got["peak_device_gb"] == pytest.approx(8.0)
    assert got["setup_s"] == 33.0
    assert harness.end_to_end(run, 1.0, 0, math.inf)["logit_bits"] is None


def test_reduce_busy_idle_and_labels():
    """Busy is the union of device activity; each idle gap goes to the
    innermost span open at its middle."""
    events = [("k_a", 0, 10), ("k_b", 5, 20), ("k_c", 30, 40)]
    spans = [("request", 0, 50, 0, False), ("ffn", 25, 35, 0, False)]
    k = Kernel(KERNEL="k_b")
    got = trace.reduce(events, 0, 50, spans, 0, [k],
                       {k: [{"rows": 1}]})
    assert got["busy_s"] == pytest.approx(30e-9)
    assert got["window_s"] == pytest.approx(50e-9)
    assert dict(got["idle_gaps"]) == pytest.approx({"ffn": 10e-9,
                                                    "request": 10e-9})
    assert dict(got["device_ops"])["k_b"] == pytest.approx(15e-9)
    assert got["kernels"][k]["seconds"] == [pytest.approx(15e-9)]
    rec = {"trace": dict(got, requests=2)}
    assert reader("device_idle_share").read(rec) == pytest.approx(40.0)
    assert reader("device_busy_s").read(rec) == pytest.approx(15e-9)


def test_roofline_share_sums():
    k1 = Kernel(ROOFLINE="ntt", cost=lambda c: (c["b"], 0, 0))
    k2 = Kernel(ROOFLINE="ntt", cost=lambda c: (0, c["m"], 0))
    hbm, mul = PEAKS["hbm_bytes_per_s"], PEAKS["int32_mul_per_s"]
    rec = {"peaks": PEAKS, "trace": {"kernels": {
        k1: {"calls": [{"b": hbm * 1e-3}, {"b": hbm * 2e-3}],
             "seconds": [4e-3, 4e-3]},
        k2: {"calls": [{"m": mul * 1e-3}], "seconds": [2e-3]}}}}
    # (1 + 2 + 1) ms of least time over (4 + 4 + 2) ms of device time
    assert roofline.share(rec, "ntt") == pytest.approx(40.0)
    assert reader("ntt_roofline").read(rec) == pytest.approx(40.0)
    assert reader("base_convert_roofline").read(rec) is None
    rec["trace"]["kernels"][k2]["seconds"].append(1e-3)   # unpaired
    assert roofline.share(rec, "ntt") is None


def test_request_mfu_and_counters():
    census = {"ntt_fwd": [[{"n": 8, "rows": 2, "tables": 1}, 3]],
              "ntt_inv": [[{"n": 8, "rows": 1, "tables": 1}, 2]],
              "base_convert": [[{"n": 8, "batch": 2, "g_valid": 3, "nd": 1,
                                 "tgt": 5, "prefolded": False}, 1]],
              "int64_products": [[4, 100]]}
    mfu = reader("request_mfu")
    # fwd 3*2*(4*3) = 72, inv 2*1*(4*2 + 8) = 32, conversion
    # 2*8*(3*5 + 3) = 288, products 100
    assert mfu.products(census) == 72 + 32 + 288 + 100
    short = dict(census, int64_products=[[4, 8]])          # 400 products
    rec = {"census": {"lengths": {"9": census, "5": short}},
           "peaks": {"int32_mul_per_s": 1e3}, "lengths": [9, 5, 9, 5],
           "requests": [{"s": 9.0, "index": 0}, {"s": 0.5, "index": 1},
                        {"s": 9.0, "index": 2}, {"s": 1.5, "index": 3}],
           "kinds": ["profiled", "plain", "spanned", "plain"]}
    # only the plain requests count, each by its own length's census
    assert mfu.read(rec) == pytest.approx(100 * 3 * 400 * 2 / (2.0 * 1e3))
    rec["kinds"][1] = rec["kinds"][3] = "spanned"
    assert mfu.read(rec) is None
    spans = trace.Spans("cpu")
    spans.spans = [("attention", 0, 10 ** 9, 0, True),
                   ("attention", 0, 10 ** 9, 0, True),
                   ("attention", 0, 3 * 10 ** 9, 1, True),
                   ("attention", 0, 7 * 10 ** 9, 2, False),
                   ("bootstrap", 0, 5, 1, True)]
    spans.counts = [{"keyswitch": 10, "combo_rot": 4, "bootstrap": 3},
                    {"keyswitch": 20, "combo_rot": 6, "bootstrap": 3}]
    rec = {"spans": spans}
    # the unsynchronized span of request 2 is not a stage's seconds
    assert reader("stage_s.attention").read(rec) == pytest.approx(2.5)
    assert reader("stage_s.ffn").read(rec) is None
    assert reader("keyswitches").read(rec) == 15
    assert reader("combo_rots").read(rec) == 5
    assert reader("bootstrapped_cts").read(rec) == 3


@pytest.mark.parametrize("profiled,want", [
    (1, ["profiled", "spanned", "plain", "spanned", "plain"]),
    (2, ["profiled", "profiled", "spanned", "plain", "spanned"])])
def test_request_kinds(profiled, want):
    """The profiled requests come first and are never synchronized; after
    them spanned and plain requests alternate."""
    spans = trace.Spans("cpu", profiled=profiled)
    assert [spans.kind(i) for i in range(5)] == want


def test_spans_synchronize_only_spanned_requests():
    class Circ:
        def ffn(self, x):
            return x + 1
    spans, circ, synced = trace.Spans("cpu", profiled=1), Circ(), []
    spans._sync = lambda: synced.append(spans.request)
    spans.wrap(circ, "ffn")
    for i in range(3):
        spans.request, spans.kinds[i] = i, spans.kind(i)
        assert circ.ffn(i) == i + 1
    assert synced == [1, 1]
    assert [(sp[0], sp[3], sp[4]) for sp in spans.spans] == [
        ("ffn", 0, False), ("ffn", 1, True)]


def test_window_clock_leaves_out_the_hooks():
    """A traced run's work between requests (the profiler's stop) does not
    take the window's time: the window holds as many requests as without
    it."""
    import time
    from types import SimpleNamespace

    class Prog:
        def forward(self, emb):
            time.sleep(0.2)
            return SimpleNamespace(c0=None, c1=None, nl=1, scale=1.0)

        def decrypt(self, out):
            return [0.0]

    def slow_hook(i, phase):
        if (i, phase) == (0, "end"):
            time.sleep(1.0)
    cell = SimpleNamespace(entry=lambda i: 0)
    run = harness.window(cell, Prog(), [SimpleNamespace(numpy=lambda: 0)],
                         0.7, "cpu", on_request=slow_hook)
    assert len(run["requests"]) == 4 and run["window_s"] < 1.0
