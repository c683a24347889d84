"""PyTorch + CUDA port of the CKKS framework and its block-major encrypted
Linformer forward, for NVIDIA Hopper (H100).

Layout mirrors the JAX package (`ops/`, `ckks/`, `poly/`, `linalg/`,
`models/`, `utils/`, `config.py`).  Residues are stored as `torch.int32`
(every prime is below 2**30); the NTT and the fused base conversion run as
hand-written CUDA kernels (`csrc/`) on a CUDA tensor and as their plain
int64 PyTorch versions on a CPU tensor.  Nothing here imports JAX.
"""
