"""The port's client and export modules (`client/datasets.py`,
`client/tokenizer.py`, `client/embeddings.py`, `io/bert_export.py`)
against the JAX package's, on `synthetic`, the committed
`tests/fixtures/r8.csv`, pickles built here and in-memory state dicts (no
corpus is downloaded): equal datasets, vocabularies, encodings, trained
embedding matrices (a torch.Generator seeded s against seed=s) and
exported files; then a corpus through the port's tokenizer, embeddings
and sample directories into the port's `cli eval`, whose result equals
the JAX CLI's on the same directories."""

import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from fhe_linformer_tpu import cli as jcli
from fhe_linformer_tpu.client import datasets as jdatasets
from fhe_linformer_tpu.client import embeddings as jembeddings
from fhe_linformer_tpu.client.tokenizer import Tokenizer as JTokenizer
from fhe_linformer_tpu.io.bert_export import export_bert_tiny as jexport
from fhe_linformer_tpu_torch import cli
from fhe_linformer_tpu_torch.client import datasets, embeddings, pipeline
from fhe_linformer_tpu_torch.client.tokenizer import (Tokenizer,
                                                      simple_tokenize)
from fhe_linformer_tpu_torch.io.bert_export import export_bert_tiny

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


def _same_dataset(a, b):
    assert (a.name, a.train_texts, a.train_labels, a.test_texts,
            a.test_labels) == (b.name, b.train_texts, b.train_labels,
                               b.test_texts, b.test_labels)


@pytest.mark.parametrize("kw", [dict(), dict(n_train=24, n_test=8,
                                             n_classes=3, seq_len=12,
                                             seed=5)])
def test_synthetic_equals_jax(kw):
    _same_dataset(datasets.synthetic(**kw), jdatasets.synthetic(**kw))


def test_csv_and_pickle_loaders_equal_jax(tmp_path):
    _same_dataset(datasets.load_r8(FIXTURES), jdatasets.load_r8(FIXTURES))
    src = datasets.load_r8(FIXTURES)
    with open(tmp_path / "20ng.pkl", "wb") as f:
        pickle.dump({"train_texts": src.train_texts,
                     "train_labels": src.train_labels,
                     "test_texts": src.test_texts,
                     "test_labels": src.test_labels}, f)
    _same_dataset(datasets.load_20ng(str(tmp_path)),
                  jdatasets.load_20ng(str(tmp_path)))
    shutil.copy(os.path.join(FIXTURES, "r8.csv"), tmp_path / "bytelevel.csv")
    _same_dataset(datasets.load_bytelevel_text(str(tmp_path)),
                  jdatasets.load_bytelevel_text(str(tmp_path)))
    rng = np.random.default_rng(0)
    with open(tmp_path / "cifar10.pkl", "wb") as f:
        pickle.dump({"train_x": rng.integers(0, 255, (6, 8, 8, 3)),
                     "train_y": [0, 1, 2, 0, 1, 2],
                     "test_x": rng.integers(0, 255, (2, 8, 8, 3)),
                     "test_y": [1, 0]}, f)
    _same_dataset(datasets.load_tfds_cifar10(str(tmp_path)),
                  jdatasets.load_tfds_cifar10(str(tmp_path)))


def test_loaders_present_and_missing_files_refused(tmp_path):
    assert set(datasets.LOADERS) == set(jdatasets.LOADERS)
    with pytest.raises(FileNotFoundError, match="no network egress"):
        datasets.load_mimic3(str(tmp_path))


def test_tokenizer_equals_jax():
    ds = datasets.synthetic(n_train=24, n_test=8, n_classes=3, seq_len=12)
    args = (ds.train_texts, ds.train_labels)
    tok, jtok = Tokenizer(*args, seq_max_len=16), \
        JTokenizer(*args, seq_max_len=16)
    assert (tok.vocab, tok.tok2id, tok.label2id, tok.id2label) == \
        (jtok.vocab, jtok.tok2id, jtok.label2id, jtok.id2label)
    np.testing.assert_array_equal(tok.labels, jtok.labels)
    words = ["alpha", "beta", "zzz_unknown"]
    for pad in (True, False):
        np.testing.assert_array_equal(tok.encode(words, pad),
                                      jtok.encode(words, pad))
    assert simple_tokenize("It's 42, ok?") == ["it's", "42", ",", "ok", "?"]


@pytest.mark.parametrize("method", ["skipgram", "cbow", "glove",
                                    "fasttext"])
def test_embeddings_equal_jax(method):
    ds = datasets.synthetic(n_train=12, n_test=4, n_classes=2, seq_len=10)
    tok = Tokenizer(ds.train_texts, ds.train_labels, seq_max_len=12)
    gen = torch.Generator().manual_seed(3)
    got = embeddings.train_embeddings(method, tok.token_lists, tok.tok2id,
                                      8, gen, epochs=1)
    want = jembeddings.train_embeddings(method, tok.token_lists, tok.tok2id,
                                        8, epochs=1, seed=3)
    assert got.shape == (tok.vocab_size, 8) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_embedding_matrix_cached(tmp_path):
    ds = datasets.synthetic(n_train=12, n_test=4, n_classes=2, seq_len=10)
    tok = Tokenizer(ds.train_texts, ds.train_labels, seq_max_len=12,
                    cache_dir=str(tmp_path / "cache"))
    mat = tok.embedding_matrix("skipgram", 8, "T", epochs=1)
    assert os.path.exists(tmp_path / "cache" / "skipgram_d8_T.pkl")
    np.testing.assert_array_equal(tok.embedding_matrix("skipgram", 8, "T"),
                                  mat)


def _bert_state_dict(d=8, ffn=32, seed=7):
    rng = np.random.default_rng(seed)
    sd = {"bert.pooler.dense.weight": rng.normal(size=(d, d)),
          "bert.pooler.dense.bias": rng.normal(size=d),
          "classifier.weight": rng.normal(size=(2, d)),
          "classifier.bias": rng.normal(size=2)}
    for part, shape in [("attention.self.query", (d, d)),
                        ("attention.self.key", (d, d)),
                        ("attention.self.value", (d, d)),
                        ("attention.output.dense", (d, d)),
                        ("intermediate.dense", (ffn, d)),
                        ("output.dense", (d, ffn))]:
        sd[f"bert.encoder.layer.0.{part}.weight"] = rng.normal(size=shape)
        sd[f"bert.encoder.layer.0.{part}.bias"] = rng.normal(size=shape[0])
    for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
        sd[f"bert.encoder.layer.0.{ln}.weight"] = rng.normal(size=d)
        sd[f"bert.encoder.layer.0.{ln}.bias"] = rng.normal(size=d)
    return sd


@pytest.mark.parametrize("wrap", ["state_dict", "model", "torch"])
def test_bert_export_equals_jax(tmp_path, wrap):
    sd = _bert_state_dict()
    if wrap == "torch":
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    obj = {"state_dict": sd} if wrap == "state_dict" else {"model": sd}
    got = export_bert_tiny(obj, str(tmp_path / "port"))
    want = jexport(obj, str(tmp_path / "jax"))
    assert got == want and len(got) == 28
    for name in got:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_corpus_to_cli_eval_equals_jax(tmp_path, capsys):
    """A corpus through the port's client path (20NG pickle loader,
    tokenizer, trained embeddings, exported sample directories) into the
    port's `cli eval`; the JAX CLI on the same directories agrees."""
    src = datasets.load_r8(FIXTURES)
    with open(tmp_path / "20ng.pkl", "wb") as f:
        pickle.dump({"train_texts": src.train_texts,
                     "train_labels": src.train_labels,
                     "test_texts": src.test_texts[:3],
                     "test_labels": src.test_labels[:3]}, f)
    ds = datasets.load_20ng(str(tmp_path))
    tok = Tokenizer(ds.train_texts + ds.test_texts,
                    ds.train_labels + ds.test_labels, seq_max_len=10,
                    cache_dir=str(tmp_path / "cache"))
    mat = tok.embedding_matrix("cbow", 8, "20NG", epochs=1)
    root = tmp_path / "eval_root"
    root.mkdir()
    labels = []
    for i, (text, label) in enumerate(zip(ds.test_texts, ds.test_labels)):
        ids = tok.encode(simple_tokenize(text), pad=False)[:6]
        pipeline.export_sample_embeddings(str(root / f"test_{i}"), mat[ids])
        labels.append(tok.label2id[label] % 5)     # preset tiny: 5 classes
    (root / "labels.txt").write_text("\n".join(map(str, labels)) + "\n")
    cli.main(["eval", "--preset", "tiny", "--eval-root", str(root),
              "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    jcli.main(["eval", "--preset", "tiny", "--eval-root", str(root)])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want and got["n"] == 3
