"""Circuit parameters and helpers shared by the encrypted Linformer
circuits (the per-token circuit itself is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ckks.ciphertext import Ciphertext


@dataclass
class CircuitParams:
    """Approximation knobs."""
    r: float = 1.0 / 8.0                  # softmax temperature
    inv_range: tuple = (-1.0, 190000.0)   # eval_inverse interval
    inv_degree: int = 119
    gelu_clip: float = 1.0 / 8.0          # GELU input pre-scale
    gelu_degree: int = 119
    tanh_scale: float = 1.0 / 18.0
    tanh_degree: int = 300
    exp_pow8: bool = True                 # Taylor(s/64)^8 vs Taylor(s/8)


def _stack(cts: list[Ciphertext]) -> Ciphertext:
    return cts[0].with_data(torch.stack([c.c0 for c in cts]),
                            torch.stack([c.c1 for c in cts]))
