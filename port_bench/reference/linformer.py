"""The plain Linformer classifier the encrypted request is judged against.

The reference application's single-layer model (Hansard-T/FHE-Linformer):
client-side CLS prepend, position add and Linformer E/F compression of the
sequence; one fused head with temperature-8 scores and a degree-6 Taylor
exponential in the softmax; the sequence-length-adaptive affine in place of
LayerNorm; an erf GELU FFN; a tanh pooler on CLS and a linear head.  Plain
PyTorch on the CPU, float64 unless a lower type is asked for (the control);
it imports nothing of the program.

Also here, because the judge needs them too: the weight and input draws
from the run's seed, and the calibration rule that sets the circuit's
approximation intervals from the plain model's intermediates.
"""

from __future__ import annotations

import math

import torch

EXP_TAYLOR = (1.0, 1.0, 1 / 2, 1 / 6, 1 / 24, 1 / 120, 1 / 720)
# affine "norm" constants (c0 + c1/sqrt(S) + c2/S) of the two affines
C1 = (1.0, 0.5, -0.25)
C2 = (0.9, -0.3, 0.2)


def weight_shapes(m: dict) -> list[tuple[str, tuple, float]]:
    """(name, shape, multiplier of scale/sqrt(fan_in)) of every drawn
    weight; a1 and a2 are 1 plus their draw."""
    d, k, f, c, s = m["d"], m["k_lin"], m["d_ffn"], m["n_classes"], \
        m["max_seq"]
    return [("E_w", (k, s + 1), 3), ("E_b", (k,), 0.3),
            ("F_w", (k, s + 1), 3), ("F_b", (k,), 0.3),
            ("pos_emb", (s, d), 3), ("cls_token", (d,), 3),
            ("WQ", (d, d), 1), ("BQ", (d,), 0.3), ("WK", (d, d), 1),
            ("BK", (d,), 0.3), ("WV", (d, d), 1), ("BV", (d,), 0.3),
            ("WO", (d, d), 1), ("BO", (d,), 0.3),
            ("a1", (d,), 1), ("b1", (d,), 0.3),
            ("W1", (f, d), 1), ("B1", (f,), 0.3), ("W2", (d, f), 1),
            ("B2", (d,), 0.3), ("a2", (d,), 1), ("b2", (d,), 0.3),
            ("Wp", (d, d), 1), ("bp", (d,), 0.3), ("Wc", (c, d), 1),
            ("bc", (c,), 0.3)]


def make_weights(model: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Every weight from one normal draw of a generator on `device`
    seeded by `seed`, float64, moved to the host."""
    shapes = weight_shapes(model)
    total = sum(math.prod(s) for _, s, _ in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float64).cpu()
    out, at = {}, 0
    for name, shape, mult in shapes:
        size = math.prod(shape)
        w = flat[at:at + size].reshape(shape) * \
            (model["weight_scale"] * mult / math.sqrt(shape[-1]))
        out[name] = 1.0 + w if name in ("a1", "a2") else w
        at += size
    out["c1"] = torch.tensor(C1, dtype=torch.float64)
    out["c2"] = torch.tensor(C2, dtype=torch.float64)
    return out


def make_embeddings(tokens: list[int], d: int, std: float, seed: int,
                    device) -> list[torch.Tensor]:
    """Request embeddings on the host, entry j of (tokens[j], d), float64:
    one normal draw of (len(tokens), max(tokens), d) on `device` from
    `seed`, entry j cut to its first tokens[j] rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    full = (std * torch.randn((len(tokens), max(tokens), d), generator=gen,
                              device=device, dtype=torch.float64)).cpu()
    return [full[j, :t] for j, t in enumerate(tokens)]


def _taylor_exp(x, r):
    acc = torch.zeros_like(x)
    for c in reversed(EXP_TAYLOR):
        acc = r(r(acc * x) + c)
    return acc


def _affine(x, a, b, c, s_total, r):
    f = c[0] + c[1] / math.sqrt(s_total) + c[2] / s_total
    return r(r(x * r(a * f)) + r(b * f))


def forward(w: dict, emb: torch.Tensor, dtype=torch.float64):
    """Logits (n_classes,) of one request's embeddings (S - 1, d) and the
    intermediates the calibration reads, computed in `dtype`.  An 8-bit
    float type (the control's) holds every weight, input and intermediate
    in that type, with each operation computed in float32 between the
    roundings, as fp8 inference runs."""
    if dtype.itemsize == 1:
        low, dtype = dtype, torch.float32
        r = lambda t: t.to(low).to(torch.float32)       # noqa: E731
    else:
        r = lambda t: t                                  # noqa: E731
    w = {k: r(v.to(dtype)) for k, v in w.items()}
    emb = r(emb.to(dtype))
    S = emb.shape[0]
    x = r(torch.cat([w["cls_token"][None],
                     r(emb + r(w["pos_emb"][:S] / 3.0))]))
    St = S + 1
    xe = r(r(w["E_w"][:, :St] @ x) + w["E_b"][:, None])
    xf = r(r(w["F_w"][:, :St] @ x) + w["F_b"][:, None])
    q = r(r(x @ w["WQ"].T) + w["BQ"])
    k = r(r(xe @ w["WK"].T) + w["BK"])
    v = r(r(xf @ w["WV"].T) + w["BV"])
    e = r(_taylor_exp(r(r(q @ k.T) * (1.0 / 8.0)), r))
    rowsum = r(e.sum(-1, keepdim=True))
    o = r(r(e / rowsum) @ v)
    x = r(_affine(r(x + r(r(o @ w["WO"].T) + w["BO"])), w["a1"], w["b1"],
                  w["c1"], St, r))
    pre = r(r(x @ w["W1"].T) + w["B1"])
    h = r(0.5 * pre * r(1.0 + r(torch.erf(r(pre / math.sqrt(2.0))))))
    x = r(_affine(r(x + r(r(h @ w["W2"].T) + w["B2"])), w["a2"], w["b2"],
                  w["c2"], St, r))
    pooled = r(r(x[:1] @ w["Wp"].T) + w["bp"])
    logits = r(r(r(torch.tanh(pooled)) @ w["Wc"].T) + w["bc"])[0]
    return logits, {"rowsum": rowsum[:, 0], "ffn_pre": pre,
                    "pooler_pre": pooled[0]}


def calibrate(w: dict, embs) -> dict:
    """The circuit's approximation intervals over every request the run
    can send: the inverse over [0.5 min, 1.5 max] of the softmax row sums,
    the GELU input pre-scaled by 1 / (1.2 max |pre-activation|) and the
    tanh input by 1 / (1.2 max |pooler pre-activation|)."""
    lo, hi, h, p = math.inf, 0.0, 0.0, 0.0
    for emb in embs:
        _, inter = forward(w, emb)
        lo = min(lo, float(inter["rowsum"].min()))
        hi = max(hi, float(inter["rowsum"].max()))
        h = max(h, float(inter["ffn_pre"].abs().max()))
        p = max(p, float(inter["pooler_pre"].abs().max()))
    return {"inv_range": (0.5 * lo, 1.5 * hi), "gelu_clip": 1.0 / (1.2 * h),
            "tanh_scale": 1.0 / (1.2 * p)}
