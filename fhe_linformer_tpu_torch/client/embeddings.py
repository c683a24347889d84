"""Word-embedding trainers: skipgram / cbow (SGNS), glove, fasttext (the
JAX package's `client/embeddings.py`, on CPU torch and numpy).

Capability parity with tokenizerFuncs.py:80-149 (which wraps gensim and
mittens, neither of which is installed).  Same four methods, same (vocab,
dim) output contract.  Each trainer takes an explicit torch.Generator
where the JAX package's seeds torch's global one: the torch draws come
from the generator and the numpy draws from default_rng(its seed), so a
generator seeded s gives the JAX package's matrices for seed=s.
"""

from __future__ import annotations

import numpy as np
import torch


def train_embeddings(method: str, token_lists, tok2id, dim: int,
                     generator: torch.Generator, window: int = 5,
                     epochs: int = 3, negatives: int = 5, min_n: int = 3,
                     max_n: int = 5) -> np.ndarray:
    seed = generator.initial_seed()
    if method in ("skipgram", "cbow"):
        return _sgns(token_lists, tok2id, dim, window, epochs, negatives,
                     cbow=(method == "cbow"), generator=generator)
    if method == "glove":
        return _glove(token_lists, tok2id, dim, window, epochs, generator)
    if method == "fasttext":
        base = _sgns(token_lists, tok2id, dim, window, epochs, negatives,
                     cbow=False, generator=generator)
        return _subword_mix(base, tok2id, dim, min_n, max_n, seed)
    raise ValueError(f"unknown embedding method {method}")


def _pairs(token_lists, tok2id, window, rng):
    centers, contexts = [], []
    for toks in token_lists:
        ids = [tok2id.get(t, 0) for t in toks]
        for i, c in enumerate(ids):
            w = int(rng.integers(1, window + 1))
            for j in range(max(0, i - w), min(len(ids), i + w + 1)):
                if j != i:
                    centers.append(c)
                    contexts.append(ids[j])
    return np.asarray(centers), np.asarray(contexts)


def _sgns(token_lists, tok2id, dim, window, epochs, negatives, cbow,
          generator):
    """Skip-gram / CBOW with negative sampling, minibatched torch CPU."""
    rng = np.random.default_rng(generator.initial_seed())
    V = len(tok2id)
    centers, contexts = _pairs(token_lists, tok2id, window, rng)
    if cbow:
        centers, contexts = contexts, centers
    emb_in = torch.nn.Embedding(V, dim)
    emb_out = torch.nn.Embedding(V, dim)
    torch.nn.init.uniform_(emb_in.weight, -0.5 / dim, 0.5 / dim,
                           generator=generator)
    torch.nn.init.zeros_(emb_out.weight)
    opt = torch.optim.Adam(list(emb_in.parameters()) +
                           list(emb_out.parameters()), lr=2e-3)
    n = len(centers)
    bs = 4096
    for _ in range(epochs):
        perm = rng.permutation(n)
        for s in range(0, n, bs):
            idx = perm[s: s + bs]
            c = torch.as_tensor(centers[idx])
            o = torch.as_tensor(contexts[idx])
            neg = torch.as_tensor(rng.integers(0, V, (len(idx), negatives)))
            vc = emb_in(c)
            pos = (vc * emb_out(o)).sum(-1)
            negs = torch.bmm(emb_out(neg), vc.unsqueeze(-1)).squeeze(-1)
            loss = (torch.nn.functional.softplus(-pos).mean() +
                    torch.nn.functional.softplus(negs).mean())
            opt.zero_grad()
            loss.backward()
            opt.step()
    return emb_in.weight.detach().numpy().astype(np.float64)


def _glove(token_lists, tok2id, dim, window, epochs, generator):
    """GloVe-style weighted log-cooccurrence factorization (mittens
    replacement, tokenizerFuncs.py:99-138)."""
    V = len(tok2id)
    cooc: dict[tuple[int, int], float] = {}
    for toks in token_lists:
        ids = [tok2id.get(t, 0) for t in toks]
        for i, c in enumerate(ids):
            for j in range(max(0, i - window), min(len(ids), i + window + 1)):
                if j == i:
                    continue
                k = (c, ids[j])
                cooc[k] = cooc.get(k, 0.0) + 1.0 / abs(j - i)
    keys = np.asarray(list(cooc.keys()), np.int64).reshape(-1, 2)
    vals = np.asarray(list(cooc.values()))
    wgt = np.minimum((vals / 100.0) ** 0.75, 1.0)
    logv = np.log(vals)
    W = torch.randn(V, dim, generator=generator).requires_grad_()
    Wc = torch.randn(V, dim, generator=generator).requires_grad_()
    b = torch.zeros(V, requires_grad=True)
    bc = torch.zeros(V, requires_grad=True)
    opt = torch.optim.Adam([W, Wc, b, bc], lr=0.05)
    ii = torch.as_tensor(keys[:, 0])
    jj = torch.as_tensor(keys[:, 1])
    wv = torch.as_tensor(wgt)
    lv = torch.as_tensor(logv)
    for _ in range(max(10, epochs * 10)):
        pred = (W[ii] * Wc[jj]).sum(-1) + b[ii] + bc[jj]
        loss = (wv * (pred - lv) ** 2).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return (W + Wc).detach().numpy().astype(np.float64)


def _subword_mix(base, tok2id, dim, min_n, max_n, seed):
    """fastText-flavored subword enrichment: average hashed char-ngram
    vectors into each word vector."""
    rng = np.random.default_rng(seed)
    nbuckets = 1 << 16
    sub = rng.normal(0, 1.0 / dim, (nbuckets, dim))
    out = base.copy()
    for tok, idx in tok2id.items():
        t = f"<{tok}>"
        grams = [t[i: i + n] for n in range(min_n, max_n + 1)
                 for i in range(len(t) - n + 1)]
        if grams:
            hs = [hash(g) % nbuckets for g in grams]
            out[idx] = (base[idx] + sub[hs].sum(0)) / (1 + len(hs))
    return out
