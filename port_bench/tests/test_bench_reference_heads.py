"""The multi-head plain reference, reference/linformer_heads.py: with one
head it is reference/linformer.py operation for operation; its heads split
the features as the port's golden model splits them; it turns TF32 off and
loads nothing of the program; and the configuration that names it states
the published model and what was cut."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, REPO

from port_bench import harness
from port_bench.reference import linformer as one_head
from port_bench.reference import linformer_heads as ref

APP = json.loads((BENCH / "configs" / "linformer-boot-w.packed.json")
                 .read_text())["model"]
BASE = json.loads((BENCH / "configs" / "linformer-base.packed.json")
                  .read_text())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float8_e4m3fn],
                         ids=["float64", "fp8"])
def test_one_head_is_the_one_head_reference(dtype):
    """The app's widths (d 128, k_lin 32, d_ffn 512): the same draws, and
    with heads=1 the same logits and intermediates bit for bit, in float64
    and on the fp8 control's path."""
    w = ref.make_weights(APP, 7, "cpu")
    w1 = one_head.make_weights(APP, 7, "cpu")
    assert w.keys() == w1.keys()
    assert all(torch.equal(w[k], w1[k]) for k in w)
    embs = ref.make_embeddings([40, 25], APP["d"], 0.3, 9, "cpu")
    for emb in embs:
        got, gi = ref.forward(w, emb, dtype, heads=1)
        want, wi = one_head.forward(w1, emb, dtype)
        assert torch.equal(got, want)
        assert all(torch.equal(gi[k], wi[k]) for k in wi)
    assert ref.calibrate(w, embs, heads=1) == one_head.calibrate(w1, embs)


def test_heads_split_as_the_golden_model():
    """Four heads of 4 features at d 16 against the port's golden model
    with heads=4, float64, on the same weights."""
    from fhe_linformer_tpu_torch.models import golden
    m = dict(d=16, k_lin=8, d_ffn=64, n_classes=5, max_seq=24,
             weight_scale=0.3)
    w = ref.make_weights(m, 3, "cpu")
    emb = ref.make_embeddings([19], 16, 0.3, 4, "cpu")[0]
    got, inter = ref.forward(w, emb, heads=4)
    gw = golden.LinformerWeights(**{k: v.numpy() for k, v in w.items()})
    _, gi = golden.forward(gw, emb.numpy(), return_intermediates=True,
                           heads=4)
    np.testing.assert_allclose(got.numpy(), gi["logits"], atol=1e-12)
    np.testing.assert_allclose(inter["rowsum"].numpy(),
                               gi["exp"].sum(-1).reshape(-1), atol=1e-12)
    assert ref.forward(w, emb)[0].shape == got.shape   # d/64: one head here


_LOAD = """
import json, sys
sys.path.insert(0, {repo!r})
from pathlib import Path
from port_bench.harness import load_module
mod = load_module(Path({path!r}))
import torch
w = mod.make_weights({{"d": 16, "k_lin": 8, "d_ffn": 64, "n_classes": 5,
                      "max_seq": 12, "weight_scale": 0.3}}, 1, "cpu")
mod.calibrate(w, mod.make_embeddings([7, 5], 16, 0.3, 2, "cpu"), heads=4)
print(json.dumps([torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32,
                  sorted({{m.split(".")[0] for m in sys.modules}})]))
"""


def test_tf32_off_and_nothing_of_the_program_loaded():
    out = subprocess.run(
        [sys.executable, "-c", _LOAD.format(
            repo=str(REPO), path=str(BENCH / "reference" /
                                     "linformer_heads.py"))],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    mm, dnn, tops = json.loads(out.stdout.strip().splitlines()[-1])
    assert (mm, dnn) == (False, False)
    assert not set(tops) & (set(harness.FORBIDDEN) | {harness.PORT})


def test_base_configuration_states_the_published_model():
    """Every width as published (768, 12 x 64, k 128, 3072), one layer of
    12 listed as the cut, the departures and the deployment written."""
    m, pub = BASE["model"], BASE["published"]
    assert (m["d"], m["heads"], m["k_lin"], m["d_ffn"]) == (
        pub["d_model"], pub["heads"], pub["k_lin"], pub["d_ffn"]) == (
        768, 12, 128, 3072)
    assert m["d"] // m["heads"] == pub["head_dim"] == ref.HEAD_DIM
    assert pub["k_lin"] == pub["max_positions"] // pub["compressed"]
    assert (m["layers"], pub["layers"]) == (1, 12)
    assert BASE["reduced"] == ["layers: 1 of 12"]
    assert BASE["departures"] and BASE["deployment"] and BASE["assumed"]
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = [c for c in man["configs"] if c["name"] == BASE["name"]][0]
    assert entry["reduced"] == ["layers"]
    assert "2006.04768" in entry["source"]
