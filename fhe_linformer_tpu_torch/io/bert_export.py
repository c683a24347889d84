"""BERT-Tiny checkpoint exporter (a copy of the JAX package's
`io/bert_export.py`, which is host numpy; reference: src/python/test.py).

The reference ships a vestigial exporter from its FHE-BERT-Tiny ancestor
(the CMake project name in the reference's CMakeLists.txt:1): it dumps an
SST-2 BERT-Tiny torch checkpoint to `weights-sst2/*.txt` column files —
per-layer Q/K/V/output projections, LayerNorm gamma ("vy") / beta
("normbias") / a zero "mean" column, the 4-way FFN row/col splits the
encrypted circuit consumes, pooler, and classifier head
(test.py:30-89, export_classifier_from_sd:91-100).

This is the same contract, torch-optional: `state_dict` may be a path to
a torch .bin, a torch state_dict, or a plain {name: ndarray} mapping —
so the exporter runs in environments without the training stack.
"""

from __future__ import annotations

import os

import numpy as np


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):           # torch tensor
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _save_col(path: str, arr) -> None:
    """Row-major flatten, one float per line (test.py save_*_txt)."""
    np.savetxt(path, _to_numpy(arr).reshape(-1), fmt="%.18e")


def _unwrap_state_dict(obj):
    """test.py:31-34 unwrap order: ["state_dict"], then ["model"]."""
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and isinstance(obj["model"], dict):
        obj = obj["model"]
    return obj


def export_bert_tiny(state_dict, out_dir: str, n_ffn_blocks: int = 4) -> list:
    """Export a BERT-Tiny state dict to the reference's weights-sst2
    layout.  Returns the list of files written.

    `state_dict`: mapping, or a path to a torch-serialized checkpoint.
    FFN up-proj splits into `n_ffn_blocks` row blocks and the down-proj
    into column blocks (test.py split_rows_4/split_cols_4 with the 512/128
    shapes generalized; block count 4 matches the reference).
    """
    if isinstance(state_dict, (str, os.PathLike)):
        import torch
        state_dict = torch.load(state_dict, map_location="cpu")
    sd = _unwrap_state_dict(state_dict)
    os.makedirs(out_dir, exist_ok=True)
    base = "bert." if any(k.startswith("bert.") for k in sd) else ""
    written = []

    def save(name, arr):
        path = os.path.join(out_dir, name)
        _save_col(path, arr)
        written.append(name)

    pw, pb = base + "pooler.dense.weight", base + "pooler.dense.bias"
    if pw in sd and pb in sd:
        save("pooler_dense_weight.txt", sd[pw])
        save("pooler_dense_bias.txt", sd[pb])

    layers = set()
    pfx = base + "encoder.layer."
    for k in sd:
        if k.startswith(pfx):
            head = k[len(pfx):].split(".")[0]
            if head.isdigit():
                layers.add(int(head))

    for i in sorted(layers):
        p = f"{pfx}{i}"
        for short, key in [("attself_query", "attention.self.query"),
                           ("attself_key", "attention.self.key"),
                           ("attself_value", "attention.self.value"),
                           ("selfoutput", "attention.output.dense")]:
            save(f"layer{i}_{short}_weight.txt", sd[f"{p}.{key}.weight"])
            save(f"layer{i}_{short}_bias.txt", sd[f"{p}.{key}.bias"])
        # LayerNorm gamma/beta + an all-zero "mean" column (test.py:69-71)
        for short, key in [("selfoutput", "attention.output.LayerNorm"),
                           ("output", "output.LayerNorm")]:
            gamma = _to_numpy(sd[f"{p}.{key}.weight"])
            save(f"layer{i}_{short}_vy.txt", gamma)
            save(f"layer{i}_{short}_normbias.txt", sd[f"{p}.{key}.bias"])
            save(f"layer{i}_{short}_mean.txt", np.zeros(gamma.shape[0]))
        inter_w = _to_numpy(sd[f"{p}.intermediate.dense.weight"])
        assert inter_w.shape[0] % n_ffn_blocks == 0, inter_w.shape
        for k, blk in enumerate(np.split(inter_w, n_ffn_blocks, axis=0), 1):
            save(f"layer{i}_intermediate_weight{k}.txt", blk)
        save(f"layer{i}_intermediate_bias.txt",
             sd[f"{p}.intermediate.dense.bias"])
        out_w = _to_numpy(sd[f"{p}.output.dense.weight"])
        assert out_w.shape[1] % n_ffn_blocks == 0, out_w.shape
        for k, blk in enumerate(np.split(out_w, n_ffn_blocks, axis=1), 1):
            save(f"layer{i}_output_weight{k}.txt", blk)
        save(f"layer{i}_output_bias.txt", sd[f"{p}.output.dense.bias"])

    for k in ("classifier.weight", "bert.classifier.weight"):
        if k in sd:
            save("classifier_weight.txt", sd[k])
            break
    for k in ("classifier.bias", "bert.classifier.bias"):
        if k in sd:
            save("classifier_bias.txt", sd[k])
            break
    return written
