"""The comparison that decides `correct`: every request the window
finished, judged against the plain reference.

For each request the reference computes the plain model's logits from the
same weights and embeddings, and decrypts the program's output
ciphertext itself, with the secret key it draws from the run's seed.  The
number compared is the largest gap, over the window's requests and the 20
classes, between the reference's logits and either the logits the client
got or the reference's own decrypt of the output ciphertext.
"""

from __future__ import annotations

import math

import numpy as np


def judge(cell, run: dict, weights: dict, embs, key_seed: int,
          dtype=None) -> dict:
    """{"max_logit_err", "decrypt_gap", "errors"} over run["requests"];
    `dtype` computes the reference's logits in a lower type (the control's
    readings)."""
    from .harness import load_module
    ref = cell.reference()
    cfg = cell.config
    dec = load_module(cell.bench / "reference" / "ckks.py").Decryptor(
        cfg["ckks"], key_seed)
    sl = cfg["logit_slots"]
    ncls = cfg["model"]["n_classes"]
    idx = [sl["start"] + i * sl["stride"] for i in range(ncls)]
    errs, gaps = [], []
    for r in run["requests"]:
        want, _ = ref.forward(weights, embs[r["index"]])
        want = want.double().numpy()
        if dtype is not None:
            low, _ = ref.forward(weights, embs[r["index"]], dtype=dtype)
            got_client = low.double().numpy()
            got_dec = got_client
        else:
            c0, c1, nl, scale = r["out"]
            got_dec = dec.slots(c0.cpu().numpy(), c1.cpu().numpy(), scale,
                                idx)
            got_client = np.asarray(r["logits"], np.float64)
        e = max(_gap(got_client, want), _gap(got_dec, want))
        errs.append(e)
        gaps.append(_gap(got_client, got_dec))
    return {"max_logit_err": max(errs) if errs else math.inf,
            "decrypt_gap": max(gaps) if gaps else math.inf,
            "errors": errs}


def _gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return math.inf
    return float(np.max(np.abs(a - b)))

