"""Corpus loaders (a copy of the JAX package's `client/datasets.py`, which
is host numpy; the port never imports it): capability parity with the
reference's src/python/utils.py:10-309.

The reference ships 10 dataset classes (MIMIC3, R8, IMDB, ASTRAL_SCOPe,
Sklearn_20NG, BBC_News, CIFAR_100, ListOps, ByteLevel_TextClassification,
TFDS_CIFAR10).  This environment has no network egress and no tfds/gensim,
so every loader takes a local `data_dir` and raises a clear error when the
files are absent; `Synthetic` provides a deterministic in-memory corpus so
the full client->encrypt->classify pipeline is testable hermetically.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class TextDataset:
    train_texts: list
    train_labels: list
    test_texts: list
    test_labels: list
    name: str = "dataset"


def _need(path: str, what: str):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{what} not found at {path} — this environment has no network "
            f"egress; place the files locally (see reference utils.py).")


def load_20ng(data_dir: str) -> TextDataset:
    """20 Newsgroups from an sklearn-style cached pickle or folder layout
    (reference Sklearn_20NG, utils.py:152)."""
    import pickle
    p = os.path.join(data_dir, "20ng.pkl")
    _need(p, "20NG cache")
    with open(p, "rb") as f:
        d = pickle.load(f)
    return TextDataset(d["train_texts"], d["train_labels"],
                       d["test_texts"], d["test_labels"], "20NG")


def load_csv_corpus(path: str, text_col: str, label_col: str,
                    name: str, test_frac: float = 0.2,
                    seed: int = 0) -> TextDataset:
    """Generic CSV loader backing R8 / BBC_News / IMDB-style corpora."""
    _need(path, f"{name} csv")
    texts, labels = [], []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            texts.append(row[text_col])
            labels.append(row[label_col])
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(texts))
    cut = int(len(texts) * (1 - test_frac))
    tr, te = idx[:cut], idx[cut:]
    return TextDataset([texts[i] for i in tr], [labels[i] for i in tr],
                       [texts[i] for i in te], [labels[i] for i in te], name)


def load_r8(data_dir: str) -> TextDataset:
    return load_csv_corpus(os.path.join(data_dir, "r8.csv"),
                           "text", "label", "R8")


def load_bbc(data_dir: str) -> TextDataset:
    return load_csv_corpus(os.path.join(data_dir, "bbc.csv"),
                           "text", "label", "BBC")


def load_imdb(data_dir: str) -> TextDataset:
    return load_csv_corpus(os.path.join(data_dir, "imdb.csv"),
                           "text", "label", "IMDB")


def load_listops(data_dir: str) -> TextDataset:
    return load_csv_corpus(os.path.join(data_dir, "listops.csv"),
                           "expr", "label", "ListOps")


def load_mimic3(data_dir: str) -> TextDataset:
    """Clinical-notes corpus (reference MIMIC3, utils.py:10 — requires the
    credentialed CSV placed locally)."""
    return load_csv_corpus(os.path.join(data_dir, "mimic3.csv"),
                           "text", "label", "MIMIC3")


def load_astral_scope(data_dir: str) -> TextDataset:
    """Protein-sequence classification (ASTRAL SCOPe, utils.py:101):
    sequences as space-separated residue tokens."""
    return load_csv_corpus(os.path.join(data_dir, "astral_scope.csv"),
                           "sequence", "fold", "ASTRAL_SCOPe")


def load_bytelevel_text(data_dir: str, name: str = "bytelevel") -> TextDataset:
    """Byte-level text classification (LRA-style, utils.py:258): texts are
    classified over raw byte tokens; we expose bytes as space-joined ints
    so the standard Tokenizer path applies."""
    ds = load_csv_corpus(os.path.join(data_dir, f"{name}.csv"),
                         "text", "label", name)
    def to_bytes(ts):
        return [" ".join(str(b) for b in t.encode("utf-8")) for t in ts]
    return TextDataset(to_bytes(ds.train_texts), ds.train_labels,
                       to_bytes(ds.test_texts), ds.test_labels, name)


def _load_image_pickle(path: str, name: str) -> TextDataset:
    """Image corpora (CIFAR_100 utils.py:209, TFDS_CIFAR10 :289) from a
    local pickle {train_x, train_y, test_x, test_y}; pixel rows are exposed
    as token sequences (the reference flattens images the same way for the
    sequence-classification pipeline)."""
    import pickle
    _need(path, name)
    with open(path, "rb") as f:
        d = pickle.load(f)

    def rows(x):
        flat = np.asarray(x).reshape(len(x), -1)
        return [" ".join(str(int(v) // 16) for v in r[:512]) for r in flat]
    return TextDataset(rows(d["train_x"]), [int(v) for v in d["train_y"]],
                       rows(d["test_x"]), [int(v) for v in d["test_y"]], name)


def load_cifar100(data_dir: str) -> TextDataset:
    return _load_image_pickle(os.path.join(data_dir, "cifar100.pkl"),
                              "CIFAR_100")


def load_tfds_cifar10(data_dir: str) -> TextDataset:
    return _load_image_pickle(os.path.join(data_dir, "cifar10.pkl"),
                              "TFDS_CIFAR10")


LOADERS = {
    "MIMIC3": load_mimic3, "R8": load_r8, "IMDB": load_imdb,
    "ASTRAL_SCOPe": load_astral_scope, "Sklearn_20NG": load_20ng,
    "BBC_News": load_bbc, "CIFAR_100": load_cifar100,
    "ListOps": load_listops, "ByteLevel_TextClassification": load_bytelevel_text,
    "TFDS_CIFAR10": load_tfds_cifar10,
}


_WORDS = ("alpha beta gamma delta epsilon zeta eta theta iota kappa lambda "
          "mu nu xi omicron pi rho sigma tau upsilon phi chi psi omega "
          "red green blue sharp flat round heavy light fast slow").split()


def synthetic(n_train: int = 64, n_test: int = 16, n_classes: int = 4,
              seq_len: int = 30, seed: int = 0) -> TextDataset:
    """Deterministic class-separable synthetic corpus for hermetic tests:
    each class favors a distinct slice of the vocabulary."""
    rng = np.random.default_rng(seed)
    per = len(_WORDS) // n_classes

    def sample(cls):
        fav = _WORDS[cls * per:(cls + 1) * per]
        toks = [fav[rng.integers(len(fav))] if rng.random() < 0.7
                else _WORDS[rng.integers(len(_WORDS))]
                for _ in range(seq_len)]
        return " ".join(toks)

    tr_l = [int(i % n_classes) for i in range(n_train)]
    te_l = [int(i % n_classes) for i in range(n_test)]
    return TextDataset([sample(c) for c in tr_l], tr_l,
                       [sample(c) for c in te_l], te_l, "synthetic")
