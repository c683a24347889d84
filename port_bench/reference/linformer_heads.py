"""The plain multi-head Linformer classifier the encrypted request of a
multi-head configuration is judged against.

Linformer-base's layer (Wang, Li, Khabsa, Fang and Ma 2020,
arXiv:2006.04768; fairseq examples/linformer, linformer_roberta_base) in
the reference application's form (Hansard-T/FHE-Linformer): client-side CLS
prepend, position add and Linformer E/F compression of the sequence, one E
and one F shared by every head; per head h over features h*hd ... h*hd +
hd - 1 (hd = d / heads), temperature-8 scores (RoBERTa's 1/sqrt(64) at
head size 64), a degree-6 Taylor exponential and a row-normalised softmax,
the heads' value mixes concatenated before WO; the sequence-length-adaptive
affine in place of LayerNorm; an erf GELU FFN; a tanh pooler on CLS and a
linear head.  Plain PyTorch on the CPU, float64 unless a lower type is
asked for (the control); it imports nothing of the program.  With one head
it computes what reference/linformer.py computes, operation for operation.

The weight and input draws from the run's seed, the Taylor exponential
and the affine are reference/linformer.py's own, imported from it, so both
references draw the same weights; the calibration rule here reads every
head's row sums.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

# reference/linformer.py, loaded by its file: a reference imports nothing
# of the benchmark or the program
_spec = importlib.util.spec_from_file_location(
    "_linformer_one_head", Path(__file__).with_name("linformer.py"))
_one_head = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_one_head)
# the draws are the harness's, the rest this forward's
make_weights, make_embeddings = _one_head.make_weights, \
    _one_head.make_embeddings
_taylor_exp, _affine = _one_head._taylor_exp, _one_head._affine

# float32 products in full float32: no TF32 on a card that offers it
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the published head size; a model's head count is d / HEAD_DIM unless
# forward is given another
HEAD_DIM = 64


def forward(w: dict, emb: torch.Tensor, dtype=torch.float64,
            heads: int | None = None):
    """Logits (n_classes,) of one request's embeddings (S - 1, d) and the
    intermediates the calibration reads (the row sums of every head,
    heads first), computed in `dtype` with `heads` heads (default d /
    HEAD_DIM).  An 8-bit float type (the control's) holds every weight,
    input and intermediate in that type, with each operation computed in
    float32 between the roundings, as fp8 inference runs."""
    if dtype.itemsize == 1:
        low, dtype = dtype, torch.float32
        r = lambda t: t.to(low).to(torch.float32)       # noqa: E731
    else:
        r = lambda t: t                                  # noqa: E731
    w = {k: r(v.to(dtype)) for k, v in w.items()}
    emb = r(emb.to(dtype))
    S = emb.shape[0]
    d = w["WQ"].shape[0]
    heads = heads or max(d // HEAD_DIM, 1)
    hd = d // heads
    x = r(torch.cat([w["cls_token"][None],
                     r(emb + r(w["pos_emb"][:S] / 3.0))]))
    St = S + 1
    xe = r(r(w["E_w"][:, :St] @ x) + w["E_b"][:, None])
    xf = r(r(w["F_w"][:, :St] @ x) + w["F_b"][:, None])
    q = r(r(x @ w["WQ"].T) + w["BQ"])
    k = r(r(xe @ w["WK"].T) + w["BK"])
    v = r(r(xf @ w["WV"].T) + w["BV"])
    outs, sums = [], []
    for h in range(heads):
        cols = slice(h * hd, (h + 1) * hd)
        e = r(_taylor_exp(r(r(q[:, cols] @ k[:, cols].T) * (1.0 / 8.0)), r))
        rowsum = r(e.sum(-1, keepdim=True))
        outs.append(r(r(e / rowsum) @ v[:, cols]))
        sums.append(rowsum[:, 0])
    o = torch.cat(outs, 1)
    x = r(_affine(r(x + r(r(o @ w["WO"].T) + w["BO"])), w["a1"], w["b1"],
                  w["c1"], St, r))
    pre = r(r(x @ w["W1"].T) + w["B1"])
    h = r(0.5 * pre * r(1.0 + r(torch.erf(r(pre / math.sqrt(2.0))))))
    x = r(_affine(r(x + r(r(h @ w["W2"].T) + w["B2"])), w["a2"], w["b2"],
                  w["c2"], St, r))
    pooled = r(r(x[:1] @ w["Wp"].T) + w["bp"])
    logits = r(r(r(torch.tanh(pooled)) @ w["Wc"].T) + w["bc"])[0]
    return logits, {"rowsum": torch.cat(sums), "ffn_pre": pre,
                    "pooler_pre": pooled[0]}


def calibrate(w: dict, embs, heads: int | None = None) -> dict:
    """The circuit's approximation intervals over every request the run
    can send: the inverse over [0.5 min, 1.5 max] of the softmax row sums
    of every head, the GELU input pre-scaled by 1 / (1.2 max
    |pre-activation|) and the tanh input by 1 / (1.2 max |pooler
    pre-activation|)."""
    lo, hi, h, p = math.inf, 0.0, 0.0, 0.0
    for emb in embs:
        _, inter = forward(w, emb, heads=heads)
        lo = min(lo, float(inter["rowsum"].min()))
        hi = max(hi, float(inter["rowsum"].max()))
        h = max(h, float(inter["ffn_pre"].abs().max()))
        p = max(p, float(inter["pooler_pre"].abs().max()))
    return {"inv_range": (0.5 * lo, 1.5 * hi), "gelu_clip": 1.0 / (1.2 * h),
            "tanh_scale": 1.0 / (1.2 * p)}
