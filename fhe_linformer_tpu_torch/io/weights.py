"""Weights in the reference pipeline's on-disk text format: one file per
tensor, `{name}.txt`, comma/whitespace separated floats (1-D tensors as a
column), under the reference exporter's names.  The same files the JAX
package reads and writes.
"""

from __future__ import annotations

import os

import numpy as np

from ..models.golden import LinformerWeights

_PFX = "linformer_transformerLayers_transformer0_"

# older names, read when the reference name is missing
_LEGACY = {
    _PFX + "selfAttn_E_weight.txt": "linformer_E_weight.txt",
    _PFX + "selfAttn_E_bias.txt": "linformer_E_bias.txt",
    _PFX + "selfAttn_F_weight.txt": "linformer_F_weight.txt",
    _PFX + "selfAttn_F_bias.txt": "linformer_F_bias.txt",
    "posEmb.txt": "linformer_posEmb.txt",
    "cls_token.txt": "linformer_clsToken.txt",
}


def read_values(path: str) -> np.ndarray:
    """Comma / whitespace / newline separated floats."""
    with open(path) as f:
        txt = f.read().replace(",", " ")
    return np.asarray([float(t) for t in txt.split()], np.float64)


def load_matrix(path: str, shape) -> np.ndarray:
    return read_values(path).reshape(shape)


def _resolve(wd: str, name: str) -> str:
    """The reference export name, else its older name where that exists."""
    path = os.path.join(wd, name)
    if not os.path.exists(path) and name in _LEGACY:
        legacy = os.path.join(wd, _LEGACY[name])
        if os.path.exists(legacy):
            return legacy
    return path


def load_reference_weights(wd: str, d: int = 128, k_lin: int = 32,
                           d_ffn: int = 512, n_classes: int = 20,
                           max_seq: int = 700) -> LinformerWeights:
    """A weights directory -> LinformerWeights (posEmb.txt, cls_token.txt,
    linformer_transformerLayers_transformer0_selfAttn_E_weight.txt, ...)."""
    m = lambda name, shape: load_matrix(_resolve(wd, name), shape)
    v = lambda name: read_values(_resolve(wd, name))
    s = lambda name: float(v(name)[0])
    return LinformerWeights(
        E_w=m(_PFX + "selfAttn_E_weight.txt", (k_lin, max_seq + 1)),
        E_b=v(_PFX + "selfAttn_E_bias.txt"),
        F_w=m(_PFX + "selfAttn_F_weight.txt", (k_lin, max_seq + 1)),
        F_b=v(_PFX + "selfAttn_F_bias.txt"),
        pos_emb=m("posEmb.txt", (max_seq, d)),
        cls_token=v("cls_token.txt"),
        WQ=m(_PFX + "selfAttn_WQ_weight.txt", (d, d)),
        BQ=v(_PFX + "selfAttn_WQ_bias.txt"),
        WK=m(_PFX + "selfAttn_WK_weight.txt", (d, d)),
        BK=v(_PFX + "selfAttn_WK_bias.txt"),
        WV=m(_PFX + "selfAttn_WV_weight.txt", (d, d)),
        BV=v(_PFX + "selfAttn_WV_bias.txt"),
        WO=m(_PFX + "selfAttn_WO_weight.txt", (d, d)),
        BO=v(_PFX + "selfAttn_WO_bias.txt"),
        c1=np.asarray([s(_PFX + "ffn_affine1_c0.txt"),
                       s(_PFX + "ffn_affine1_c1.txt"),
                       s(_PFX + "ffn_affine1_c2.txt")]),
        a1=v(_PFX + "ffn_affine1_a.txt"),
        b1=v(_PFX + "ffn_affine1_b.txt"),
        W1=m(_PFX + "ffn_Wffn_0_weight.txt", (d_ffn, d)),
        B1=v(_PFX + "ffn_Wffn_0_bias.txt"),
        W2=m(_PFX + "ffn_Wffn_2_weight.txt", (d, d_ffn)),
        B2=v(_PFX + "ffn_Wffn_2_bias.txt"),
        c2=np.asarray([s(_PFX + "ffn_affine2_c0.txt"),
                       s(_PFX + "ffn_affine2_c1.txt"),
                       s(_PFX + "ffn_affine2_c2.txt")]),
        a2=v(_PFX + "ffn_affine2_a.txt"),
        b2=v(_PFX + "ffn_affine2_b.txt"),
        Wp=m("pooler_dense_weight.txt", (d, d)),
        bp=v("pooler_dense_bias.txt"),
        Wc=m("fcLinear_0_weight.txt", (n_classes, d)),
        bc=v("fcLinear_0_bias.txt"),
    )


def save_reference_weights(wd: str, w: LinformerWeights):
    """Writes w in that format and those names: 1-D tensors as a column,
    2-D row-major with ',' delimiters."""
    os.makedirs(wd, exist_ok=True)
    def wv(name, arr):
        a = np.asarray(arr, np.float64)
        if a.ndim <= 1:
            a = np.atleast_1d(a).reshape(-1, 1)
        np.savetxt(os.path.join(wd, name), a, fmt="%.18e", delimiter=",")
    wv(_PFX + "selfAttn_E_weight.txt", w.E_w)
    wv(_PFX + "selfAttn_E_bias.txt", w.E_b)
    wv(_PFX + "selfAttn_F_weight.txt", w.F_w)
    wv(_PFX + "selfAttn_F_bias.txt", w.F_b)
    wv("posEmb.txt", w.pos_emb)
    wv("cls_token.txt", w.cls_token)
    for nm, W, b in [("WQ", w.WQ, w.BQ), ("WK", w.WK, w.BK),
                     ("WV", w.WV, w.BV), ("WO", w.WO, w.BO)]:
        wv(_PFX + f"selfAttn_{nm}_weight.txt", W)
        wv(_PFX + f"selfAttn_{nm}_bias.txt", b)
    for i, (c, a, b) in enumerate([(w.c1, w.a1, w.b1), (w.c2, w.a2, w.b2)], 1):
        for j in range(3):
            wv(_PFX + f"ffn_affine{i}_c{j}.txt", c[j])
        wv(_PFX + f"ffn_affine{i}_a.txt", a)
        wv(_PFX + f"ffn_affine{i}_b.txt", b)
    wv(_PFX + "ffn_Wffn_0_weight.txt", w.W1)
    wv(_PFX + "ffn_Wffn_0_bias.txt", w.B1)
    wv(_PFX + "ffn_Wffn_2_weight.txt", w.W2)
    wv(_PFX + "ffn_Wffn_2_bias.txt", w.B2)
    wv("pooler_dense_weight.txt", w.Wp)
    wv("pooler_dense_bias.txt", w.bp)
    wv("fcLinear_0_weight.txt", w.Wc)
    wv("fcLinear_0_bias.txt", w.bc)
