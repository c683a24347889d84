"""The port's command line (python -m fhe_linformer_tpu_torch.cli) on the
CPU at preset `tiny`, the flow of tests/test_cli_e2e.py:

  * keygen -> infer --keys-dir --cls-only (with generate_keys poisoned, so
    the keystore is what the circuit runs on) -> golden: argmax equal
  * infer --save-checkpoint, then --resume-checkpoint: the same logits
  * infer --packed and eval --encrypted on the same files
  * a keystore written by the JAX package's `cli keygen --preset tiny`
    loads in the port and equals the port's generate_keys for the preset
  * the rotation sets of both CLIs agree; --device defaults to the card
  * `security` prints the JAX CLI's lines; `bench` prints its case's JSON
"""

import json

import numpy as np
import pytest
import torch

from fhe_linformer_tpu import cli as jcli
from fhe_linformer_tpu import config as jconfig
from fhe_linformer_tpu_torch import cli, config
from fhe_linformer_tpu_torch.ckks import keys as ckks_keys
from fhe_linformer_tpu_torch.ckks.context import Context
from fhe_linformer_tpu_torch.client import pipeline
from fhe_linformer_tpu_torch.io.serialize import load_keys
from fhe_linformer_tpu_torch.io.weights import save_reference_weights
from fhe_linformer_tpu_torch.models import golden

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Weights, one sample and a keystore written by the port's keygen."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("cli")
    wd, sd, kd = (str(root / x) for x in ("weights", "sample", "keys"))
    w = golden.random_weights(d=8, k_lin=4, d_ffn=32, n_classes=5,
                              max_seq=12, seed=31, scale=0.3)
    save_reference_weights(wd, w)
    emb = np.random.default_rng(7).normal(0, 0.3, (3, 8))
    pipeline.export_sample_embeddings(sd, emb)
    cli.main(["keygen", "--preset", "tiny", "--keys-dir", kd] + CPU)
    return root, w, emb, ["--weights-dir", wd, "--sample-dir", sd], kd


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_keygen_infer_golden(files, capsys, monkeypatch):
    root, w, emb, io, kd = files
    capsys.readouterr()

    def poisoned(*a, **k):
        raise AssertionError("generate_keys called on the --keys-dir path")
    monkeypatch.setattr(ckks_keys, "generate_keys", poisoned)
    cli.main(["infer", "--preset", "tiny", "--keys-dir", kd, "--cls-only"]
             + io + CPU)
    enc = _last_json(capsys)
    monkeypatch.undo()
    cli.main(["golden", "--preset", "tiny"] + io)
    gold = _last_json(capsys)
    want = golden.forward(w, emb, cls_only=True,
                          return_intermediates=True)[1]["logits"]
    np.testing.assert_allclose(enc["logits"], want, atol=0.08, rtol=0.08)
    assert enc["pred"] == int(np.argmax(want))
    assert gold["pred"] == int(np.argmax(golden.forward(w, emb)))
    assert len(gold["logits"]) == 5


def test_checkpoint_save_resume(files, capsys):
    root, _, _, io, kd = files
    ck = str(root / "encoder.ct")
    base = ["infer", "--preset", "tiny", "--keys-dir", kd, "--cls-only"] + \
        io + CPU
    cli.main(base + ["--save-checkpoint", ck])
    first = _last_json(capsys)
    cli.main(base + ["--resume-checkpoint", ck])
    assert _last_json(capsys)["logits"] == first["logits"]


def test_packed_infer_and_encrypted_eval(files, capsys):
    root, w, emb, io, kd = files
    cli.main(["infer", "--preset", "tiny", "--keys-dir", kd, "--packed"]
             + io + CPU)
    out = _last_json(capsys)
    want = golden.forward(w, emb, return_intermediates=True)[1]["logits"]
    assert out["packed"] and out["pred"] == int(np.argmax(want))
    er = root / "eval"
    er.mkdir()
    pipeline.export_sample_embeddings(str(er / "test_0"), emb)
    (er / "labels.txt").write_text(f"{int(np.argmax(want))}\n")
    cli.main(["eval", "--preset", "tiny", "--weights-dir", io[1],
              "--eval-root", str(er), "--encrypted"] + CPU)
    res = _last_json(capsys)
    assert res["n"] == 1 and res["accuracy"] == 1.0
    assert res["encrypted_golden_agreement"] == 1.0


def test_jax_keygen_keystore_equals_port_keys(tmp_path, capsys):
    kd = str(tmp_path / "jkeys")
    jcli.main(["keygen", "--preset", "tiny", "--keys-dir", kd])
    p = config.get("tiny")
    ctx = Context(p.ckks, device="cpu")
    loaded = load_keys(kd, ctx)
    keys = ckks_keys.generate_keys(ctx, rotations=cli._preset_rotations(p, ctx),
                                   conj=True)
    assert sorted(loaded.rot) == sorted(keys.rot)
    pairs = [(loaded.relin, keys.relin), (loaded.conj, keys.conj)] + \
        [(loaded.rot[r], keys.rot[r]) for r in keys.rot]
    for a, b in pairs:
        assert torch.equal(a.b, b.b) and torch.equal(a.a, b.a)
    assert torch.equal(loaded.pk.p0, keys.pk.p0)
    assert torch.equal(loaded.sk.eval_full, keys.sk.eval_full)


@pytest.mark.parametrize("preset", ["tiny", "multi-layer"])
def test_preset_rotations_equal_jax(preset):
    class Ctx:        # _preset_rotations reads only the config
        def __init__(self, cfg):
            self.cfg = cfg
    p, jp = config.get(preset), jconfig.get(preset)
    assert cli._preset_rotations(p, Ctx(p.ckks)) == \
        jcli._preset_rotations(jp, Ctx(jp.ckks))


def test_device_defaults_to_the_card(files):
    _, _, _, io, _ = files
    args = ["infer", "--preset", "tiny"] + io
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)


def test_security_and_bench_commands(capsys, monkeypatch):
    """`security` prints the JAX CLI's lines for every preset; `bench`
    prints the key-switch case's JSON (stubbed here: at N = 2^15 the CPU
    path takes minutes)."""
    jcli.main(["security"])
    want = capsys.readouterr().out
    cli.main(["security"])
    assert capsys.readouterr().out == want
    from fhe_linformer_tpu_torch import bench
    seen = []
    monkeypatch.setattr(bench, "keyswitches_per_s",
                        lambda device: seen.append(device) or {"ms": 1.0})
    cli.main(["bench", "--device", "cpu"])
    assert seen == ["cpu"] and _last_json(capsys) == {"ms": 1.0}
