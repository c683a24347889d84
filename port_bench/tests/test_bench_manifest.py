"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def man():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level(man):
    assert set(man) == KEYS
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert man["paths"] == ["port_bench"]
    assert man["command"][:3] == ["python3", "-m", "port_bench.run"]
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the check's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(man):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in man[k]}) == len(man[k])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_configs(man):
    used = {w["config"] for w in man["workloads"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("port_bench/configs/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert c["reduced"] == []          # one layer: nothing cut
        assert cfg["limits"]["max_logit_err"] > 0
        assert (BENCH / "circuits" / f"{cfg['circuit']['kind']}.py").exists()
        assert (BENCH / "reference" / f"{cfg['reference']}.py").exists()


def test_workloads(man):
    pairs = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH / "cells" / f"{w['name']}.census.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(man["workloads"])


def test_metrics(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reader = BENCH / "metrics" / f"{m['name']}.py"
        assert reader.exists() and "def read(" in reader.read_text()
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in man["workloads"]:
        per = [m for m in man["per_layer"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert per and len(e2e) >= 2
    assert all(1 <= len(x) <= 200 for x in layers)


def test_discovery_by_name(man):
    """Every cell's files are found by the names in the manifest alone."""
    from port_bench import harness
    for w in man["workloads"]:
        cell = harness.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert min(cell.lengths()) > 1 and cell.census is not None
        for m in cell.metrics(trace=True):
            assert callable(cell.reader(m["name"]).read)
        assert cell.circuit().build and cell.reference().forward
    kernels = harness.Cell(man["workloads"][0]["name"]).kernels()
    assert {k.KERNEL for k in kernels} == {
        "ntt_fwd_kernel", "ntt_inv_kernel", "base_convert_kernel"}


@pytest.mark.parametrize("change,message", [
    ({"loop": "open"}, "closed loop"),
    ({"clients": 2}, "closed loop"),
    ({"rate_per_s": 1.0}, "does not read"),
    ({"seq_lens": []}, "seq_lens"),
    ({"seq_lens": [8, 6], "pool": 5}, "multiple"),
])
def test_traffic_the_harness_does_not_run_is_refused(change, message):
    from port_bench import harness
    tr = json.loads((BENCH / "tests" / "data" / "closed-s8.json")
                    .read_text())
    with pytest.raises(ValueError, match=message):
        harness.check_traffic(dict(tr, **change))


def test_lengths_per_request():
    """A traffic file gives each request its length: the pool cycles its
    seq_lens, the warm-up takes one entry of each length, and the window
    starts after the warm-up's cycle."""
    from conftest import DATA, tiny_manifest

    from port_bench import harness
    man = tiny_manifest()
    man["workloads"][0]["traffic"] = "mixed-s6-8"
    cell = harness.Cell("t-packed", man, traffic_dir=DATA)
    assert cell.lengths() == [8, 6, 8, 8, 6, 8]
    assert cell.warm_entries() == [0, 1]
    assert [cell.entry(i) for i in range(5)] == [3, 4, 5, 0, 1]
    weights, embs, _ = harness.inputs(cell, 5, "cpu")
    assert [len(e) for e in embs] == [7, 5, 7, 7, 5, 7]
