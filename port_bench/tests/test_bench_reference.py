"""The plain reference against the program it judges, on the CPU: the
chain, the secret key, the NTT, the model, and the decrypt of the
program's output at the CPU test size."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from conftest import BENCH, tiny_cell

from port_bench import harness, judge, run
from port_bench.reference import ckks as ref_ckks
from port_bench.reference import linformer as ref_model

CELL_CFG = json.loads((BENCH / "configs" / "linformer-boot-w.packed.json")
                      .read_text())


def _port_cfg(ck, seed=5):
    from fhe_linformer_tpu_torch.ckks.context import CKKSConfig
    return CKKSConfig(**{k: v for k, v in ck.items() if k != "preset"},
                      seed=seed)


def test_chain_equals_the_programs():
    from fhe_linformer_tpu_torch.ckks.context import modulus_chain
    qs, _, _ = modulus_chain(_port_cfg(CELL_CFG["ckks"]))
    assert ref_ckks.q_chain(CELL_CFG["ckks"]) == list(qs)


@pytest.mark.parametrize("seed", [5, 2 ** 40 + 3])
def test_secret_key_equals_the_programs(seed):
    from fhe_linformer_tpu_torch.ckks.keys import KeyGenerator
    cfg = _port_cfg(CELL_CFG["ckks"], seed)
    kg = KeyGenerator(SimpleNamespace(cfg=cfg))
    assert np.array_equal(kg.ternary(),
                          ref_ckks.secret_key(cfg.n, cfg.secret_hw, seed))


def test_ntt_equals_the_programs():
    from fhe_linformer_tpu_torch.ops import ntt
    ck = dict(CELL_CFG["ckks"], n=1 << 12, num_scaling=6)
    dec = ref_ckks.Decryptor(ck, 1)
    qs = dec.qs[:3]
    tables = ntt.NttTables(ck["n"], qs, "cpu")
    x = np.random.default_rng(0).integers(0, 2 ** 29, (3, ck["n"]))
    x = x % np.asarray(qs)[:, None]
    want = ntt.fwd_plain(torch.from_numpy(x).int(), tables,
                         (0, 1, 2)).numpy()
    for i, q in enumerate(qs):
        assert np.array_equal(dec.ntt(x[i], q), want[i])
        assert np.array_equal(dec.intt(want[i], q), x[i])


def test_model_equals_the_programs_golden():
    from fhe_linformer_tpu_torch.models import golden
    model = dict(CELL_CFG["model"], max_seq=40)
    w = ref_model.make_weights(model, 9, "cpu")
    emb = ref_model.make_embeddings([30], model["d"], 0.3, 4, "cpu")[0]
    got, inter = ref_model.forward(w, emb)
    lw = golden.LinformerWeights(**{k: v.numpy() for k, v in w.items()})
    _, want = golden.forward(lw, emb.numpy(), return_intermediates=True)
    np.testing.assert_allclose(got.numpy(), want["logits"], atol=1e-12)
    np.testing.assert_allclose(inter["rowsum"].numpy(),
                               want["exp"].sum(-1), rtol=1e-12)


@pytest.mark.parametrize("kind", ["packed", "pertoken"])
def test_decrypt_and_logits_against_the_program(kind):
    """A run at the CPU test size: the reference's decrypt of each output
    ciphertext equals the client's, and both are near the plain model."""
    cell = tiny_cell(kind)
    res = run.measure(cell, 2 ** 33 + 17, 0.1, False, device="cpu")
    assert res["correct"] and res["attempted"] == len(res["run"]["requests"])
    v = res["verdict"]
    assert v["decrypt_gap"] < 1e-9
    assert v["max_logit_err"] < 1e-4
    # the judge reads the output ciphertext: a changed one is seen
    r = res["run"]["requests"][0]
    c0, c1, nl, scale = r["out"]
    r["out"] = (c0, c1, nl, scale * 1.5)
    weights, embs, _ = harness.inputs(cell, 2 ** 33 + 17, "cpu")
    moved = judge.judge(cell, {"requests": [r]}, weights, embs,
                        harness.seeds(2 ** 33 + 17)["key"])
    assert moved["max_logit_err"] > 1e-3


def test_a_run_of_mixed_lengths_is_correct(monkeypatch):
    """A traffic file of several lengths: each is warmed up, the window
    sends them in the pool's order, and each is judged at its own length.
    The window's clock is a counter, so it holds two requests whatever the
    machine's speed."""
    from conftest import DATA, tiny_manifest

    class Clock:
        t = 0.0

        def perf_counter(self):
            self.t += 1.0
            return self.t
    man = tiny_manifest()
    man["workloads"][0]["traffic"] = "mixed-s6-8"
    cell = harness.Cell("t-packed", man, traffic_dir=DATA)
    monkeypatch.setattr(harness, "time", Clock())
    res = run.measure(cell, 2 ** 35 + 1, 2.5, False, device="cpu")
    assert res["correct"], res["verdict"]
    assert res["verdict"]["max_logit_err"] < 1e-4
    sent = [cell.lengths()[r["index"]] for r in res["run"]["requests"]]
    assert sent == [8, 6]
