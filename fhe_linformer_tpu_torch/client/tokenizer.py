"""Client-side tokenizer: vocab, padding, label maps, embedding cache (a
copy of the JAX package's `client/tokenizer.py`, which is host numpy).

Parity with src/python/tokenizerFuncs.py:19-153 (UNK/PAD handling :22-32,
pad/truncate :56-62, label maps :34-53, per-method embedding cache
:71-75) — re-implemented without the gensim/mittens dependency chain (not
in this image): trainers live in client/embeddings.py on numpy/torch.
"""

from __future__ import annotations

import os
import pickle
import re

import numpy as np

UNK, PAD = "[UNK]", "[PAD]"
_TOKEN_RE = re.compile(r"[A-Za-z']+|[0-9]+|[^\sA-Za-z0-9]")


def simple_tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text.lower())


class Tokenizer:
    def __init__(self, texts, labels, seq_max_len: int = 700,
                 min_count: int = 1, cache_dir: str = "cache"):
        self.seq_max_len = seq_max_len
        self.cache_dir = cache_dir
        self.token_lists = [simple_tokenize(t) for t in texts]
        counts: dict[str, int] = {}
        for toks in self.token_lists:
            for t in toks:
                counts[t] = counts.get(t, 0) + 1
        vocab = [UNK, PAD] + sorted(t for t, c in counts.items()
                                    if c >= min_count)
        self.vocab = vocab
        self.tok2id = {t: i for i, t in enumerate(vocab)}
        uniq = sorted(set(labels))
        self.label2id = {l: i for i, l in enumerate(uniq)}
        self.id2label = {i: l for l, i in self.label2id.items()}
        self.labels = np.asarray([self.label2id[l] for l in labels])

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, tokens: list[str], pad: bool = True) -> np.ndarray:
        ids = [self.tok2id.get(t, 0) for t in tokens][: self.seq_max_len]
        if pad:
            ids = ids + [1] * (self.seq_max_len - len(ids))
        return np.asarray(ids, np.int64)

    def sequences(self, pad: bool = False) -> list[np.ndarray]:
        return [self.encode(toks, pad) for toks in self.token_lists]

    # -- embedding cache (tokenizerFuncs.py:71-75 parity) ---------------

    def _cache_path(self, method: str, dim: int, suffix: str) -> str:
        return os.path.join(self.cache_dir, f"{method}_d{dim}_{suffix}.pkl")

    def embedding_matrix(self, method: str, dim: int, suffix: str,
                         generator=None, **train_kw) -> np.ndarray:
        """(vocab_size, dim) embeddings, trained on this corpus and cached
        per (method, dim, suffix) like the reference blobs
        (.MISSING_LARGE_BLOBS: cbow_d128_BBC, fasttext_d128_IMDB, ...).
        `generator`: the trainer's torch.Generator (default: one seeded
        0, the JAX package's default seed)."""
        path = self._cache_path(method, dim, suffix)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        from .embeddings import train_embeddings
        if generator is None:
            import torch
            generator = torch.Generator().manual_seed(0)
        mat = train_embeddings(method, self.token_lists, self.tok2id, dim,
                               generator, **train_kw)
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(mat, f)
        return mat
