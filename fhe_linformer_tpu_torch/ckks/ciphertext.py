"""Ciphertext / plaintext wrappers.

The wrapper owns the (nl, scale) bookkeeping; the residue tensors are
(..., nl, N) int32 in the evaluation domain, with any leading batch dims.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Ciphertext:
    c0: torch.Tensor         # (..., nl, N) int32, eval domain
    c1: torch.Tensor
    nl: int                  # active q-limb count
    scale: float

    @property
    def batch_shape(self):
        return self.c0.shape[:-2]

    def with_data(self, c0, c1, nl=None, scale=None) -> "Ciphertext":
        return Ciphertext(c0, c1, self.nl if nl is None else nl,
                          self.scale if scale is None else scale)


@dataclass
class Plaintext:
    data: torch.Tensor       # (..., nl, N) int32 eval domain, or (nl, 1)
    nl: int
    scale: float


@dataclass
class CoeffPlaintext:
    """Level-independent plaintext: the scaled integer coefficients, (N,)
    int64 on the device.  Spread over any basis and NTT'd at use (the
    rotation combo's diagonals), so thousands of matmul diagonals stay
    cached at 256 KB each at N = 2^15."""
    coeffs: torch.Tensor
    scale: float
