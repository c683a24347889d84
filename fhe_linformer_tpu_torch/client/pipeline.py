"""Client-side file pipeline: embedding export, the plaintext E/F
projection, softmax.

  * export_sample_embeddings / load_sample_embeddings: one file per token,
    `input_{i}.txt`, one value per line
  * project_ef: `XE_{i}.txt` / `XF_{i}.txt`, the Linformer sequence
    compression the client runs before encrypting
  * softmax_argmax: the client's decode of the decrypted logits
"""

from __future__ import annotations

import os

import numpy as np

from ..models.golden import LinformerWeights, client_preprocess


def export_sample_embeddings(out_dir: str, emb: np.ndarray):
    """Per-token embedding files input_{i}.txt (one value per line)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, row in enumerate(np.asarray(emb)):
        np.savetxt(os.path.join(out_dir, f"input_{i}.txt"), row, fmt="%.18e")


def load_sample_embeddings(in_dir: str) -> np.ndarray:
    files = sorted((f for f in os.listdir(in_dir)
                    if f.startswith("input_") and f.endswith(".txt")),
                   key=lambda f: int(f[6:-4]))
    return np.stack([np.loadtxt(os.path.join(in_dir, f)) for f in files])


def project_ef(out_dir: str, w: LinformerWeights, emb: np.ndarray):
    """Write the XE_i / XF_i rows; returns (x_in, X_E, X_F)."""
    os.makedirs(out_dir, exist_ok=True)
    x_in, X_E, X_F = client_preprocess(w, emb)
    for i in range(X_E.shape[0]):
        np.savetxt(os.path.join(out_dir, f"XE_{i}.txt"), X_E[i], fmt="%.18e")
        np.savetxt(os.path.join(out_dir, f"XF_{i}.txt"), X_F[i], fmt="%.18e")
    return x_in, X_E, X_F


def softmax_argmax(logits: np.ndarray):
    """Numerically stable softmax + argmax."""
    z = np.asarray(logits, np.float64)
    e = np.exp(z - z.max())
    p = e / e.sum()
    return int(np.argmax(p)), p
