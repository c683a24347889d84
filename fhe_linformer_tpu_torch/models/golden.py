"""Plaintext golden Linformer: the executable oracle the encrypted circuit
is checked against (a copy of the JAX package's `models/golden.py`).

A single fused head (or `heads` heads of d_model / heads features, each
with its own softmax), Linformer-projected K/V (client-side E/F
compression), temperature-8 softmax with a deg-6 Taylor of e^x,
sequence-length-adaptive affine in place of LayerNorm, tanh pooler on CLS,
linear head.  Fully parameterized (d_model, k_lin, d_ffn, n_classes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

EXP_TAYLOR = (1.0, 1.0, 1 / 2, 1 / 6, 1 / 24, 1 / 120, 1 / 720)


def taylor_exp(x: np.ndarray) -> np.ndarray:
    acc = np.zeros_like(x)
    for c in reversed(EXP_TAYLOR):
        acc = acc * x + c
    return acc


def gelu(x: np.ndarray) -> np.ndarray:
    from scipy.special import erf
    return 0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))


@dataclass
class LinformerWeights:
    # client-side compression
    E_w: np.ndarray        # (k_lin, max_seq + 1)
    E_b: np.ndarray        # (k_lin,)
    F_w: np.ndarray
    F_b: np.ndarray
    pos_emb: np.ndarray    # (max_seq, d)
    cls_token: np.ndarray  # (d,)
    # attention
    WQ: np.ndarray         # (d, d)
    BQ: np.ndarray
    WK: np.ndarray
    BK: np.ndarray
    WV: np.ndarray
    BV: np.ndarray
    WO: np.ndarray
    BO: np.ndarray
    # affine "norm" 1 (c0 + c1/sqrt(S) + c2/S, then x*a*fL + b*fL)
    c1: np.ndarray         # (3,)
    a1: np.ndarray         # (d,)
    b1: np.ndarray
    # ffn
    W1: np.ndarray         # (d_ffn, d)
    B1: np.ndarray
    W2: np.ndarray         # (d, d_ffn)
    B2: np.ndarray
    c2: np.ndarray
    a2: np.ndarray
    b2: np.ndarray
    # pooler + classifier
    Wp: np.ndarray         # (d, d)
    bp: np.ndarray
    Wc: np.ndarray         # (n_classes, d)
    bc: np.ndarray

    @property
    def d(self):
        return self.WQ.shape[0]

    @property
    def k_lin(self):
        return self.E_w.shape[0]


def random_weights(d=128, k_lin=32, d_ffn=None, n_classes=20, max_seq=700,
                   seed=0, scale=0.25) -> LinformerWeights:
    """Seeded synthetic weights at inference-plausible magnitudes."""
    d_ffn = d_ffn or 4 * d
    rng = np.random.default_rng(seed)
    g = lambda *s: rng.normal(0, scale / np.sqrt(s[-1]), s)
    return LinformerWeights(
        E_w=g(k_lin, max_seq + 1) * 3, E_b=g(k_lin) * 0.3,
        F_w=g(k_lin, max_seq + 1) * 3, F_b=g(k_lin) * 0.3,
        pos_emb=g(max_seq, d) * 3, cls_token=g(d) * 3,
        WQ=g(d, d), BQ=g(d) * 0.3, WK=g(d, d), BK=g(d) * 0.3,
        WV=g(d, d), BV=g(d) * 0.3, WO=g(d, d), BO=g(d) * 0.3,
        c1=np.asarray([1.0, 0.5, -0.25]), a1=1.0 + g(d), b1=g(d) * 0.3,
        W1=g(d_ffn, d), B1=g(d_ffn) * 0.3, W2=g(d, d_ffn), B2=g(d) * 0.3,
        c2=np.asarray([0.9, -0.3, 0.2]), a2=1.0 + g(d), b2=g(d) * 0.3,
        Wp=g(d, d), bp=g(d) * 0.3, Wc=g(n_classes, d), bc=g(n_classes) * 0.3,
    )


def client_preprocess(w: LinformerWeights, emb: np.ndarray):
    """Token embeddings (S, d) -> (x_in, X_E, X_F): CLS prepend, position
    add (/3), and the plaintext Linformer E/F sequence compression (runs
    client-side, before encryption)."""
    S = emb.shape[0]
    x_in = np.vstack([w.cls_token[None], emb + w.pos_emb[:S] / 3.0])
    St = S + 1
    X_E = w.E_w[:, :St] @ x_in + w.E_b[:, None]
    X_F = w.F_w[:, :St] @ x_in + w.F_b[:, None]
    return x_in, X_E, X_F


def affine_norm(x, a, b, c, S_total):
    fL = c[0] + c[1] / np.sqrt(S_total) + c[2] / S_total
    return x * (a * fL)[None, :] + (b * fL)[None, :]


def _encoder_layer(w: LinformerWeights, x_in, X_E, X_F, cls_only, inter,
                   heads=1):
    """One golden encoder layer (attention + affine1 + FFN + affine2).
    With several heads, the score, exp, attn intermediates are stacked
    (heads, rows, k)."""
    St = x_in.shape[0]
    Q = x_in @ w.WQ.T + w.BQ[None]
    K = X_E @ w.WK.T + w.BK[None]
    V = X_F @ w.WV.T + w.BV[None]
    r = 1.0 / 8.0
    rows = Q[:1] if cls_only else Q
    hd = Q.shape[1] // heads
    parts = []
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)
        sc = rows[:, cols] @ K[:, cols].T * r
        e = taylor_exp(sc)
        at = e / e.sum(-1, keepdims=True)
        parts.append((sc, e, at, at @ V[:, cols]))
    scores, e, attn = (p[0] if heads == 1 else np.stack(p)
                       for p in list(zip(*parts))[:3])
    O = np.concatenate([p[3] for p in parts], axis=1)
    attn_out = O @ w.WO.T + w.BO[None]
    if cls_only:
        pad = np.zeros_like(x_in)
        pad[:1] = attn_out
        attn_out = pad
    inter.update(Q=Q, K=K, V=V, scores=scores, exp=e, attn=attn,
                 attn_out=attn_out)
    x = x_in + attn_out
    x = affine_norm(x, w.a1, w.b1, w.c1, St)
    inter["norm1"] = x
    h = gelu(x @ w.W1.T + w.B1[None])
    y = h @ w.W2.T + w.B2[None]
    x = x + y
    x = affine_norm(x, w.a2, w.b2, w.c2, St)
    inter["norm2"] = x
    return x


def forward(w: LinformerWeights, emb: np.ndarray, cls_only: bool = False,
            return_intermediates: bool = False, extra_layers=None,
            heads: int = 1):
    """Full golden forward from raw token embeddings to class
    probabilities.  extra_layers: weights for layers 2..N, whose E/F
    compression projects the layer-input activations."""
    x_in, X_E, X_F = client_preprocess(w, emb)
    St = x_in.shape[0]
    inter = {}
    x = _encoder_layer(w, x_in, X_E, X_F, cls_only, inter, heads)
    for lw in (extra_layers or []):
        XE = lw.E_w[:, :St] @ x + lw.E_b[:, None]
        XF = lw.F_w[:, :St] @ x + lw.F_b[:, None]
        x = _encoder_layer(lw, x, XE, XF, False, inter, heads)

    # pooler/classifier are model-level heads (first weights object's)
    cls = np.tanh(x[:1] @ w.Wp.T + w.bp[None])
    logits = (cls @ w.Wc.T + w.bc[None])[0]
    inter.update(pooled=cls, logits=logits)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    if return_intermediates:
        return p, inter
    return p
