"""Modular arithmetic on RNS residue tensors (plain PyTorch).

Residues are stored as `torch.int32`: every prime q is below 2**30, so a
residue, and the sum of two, fits a signed 32-bit lane.  Products need 64
bits and go through int64 (torch on the CPU has no uint32 add, shift,
compare or remainder).  Moduli are (L, 1) int32 tensors (or scalars) that
broadcast against (..., L, N) residues.

`barrett_mulmod` and `shoup_mulmod` are the JAX package's two multiplies
with its arguments, computed exactly in int64; the 16-bit-half `mulhi32`
the TPU needed has no counterpart.  Every multiply returns the canonical
residue, so the evaluator uses the plain `mulmod` (an int64 remainder),
which is bit-identical to both.
"""

from __future__ import annotations

import numpy as np
import torch


def mulmod(a, b, q) -> torch.Tensor:
    """a*b mod q as int32; exact while a*b < 2**63 (a < 2**33, b < q)."""
    return torch.remainder(a.long() * b, q).int()


def barrett_params(q: int) -> tuple[int, int, int]:
    """(q, mu, shift) for barrett_mulmod: mu = floor(2**(2b+1) / q) with
    b = bitlen(q), shift = b + 2."""
    b = int(q).bit_length()
    mu = (1 << (2 * b + 1)) // q
    assert mu < 1 << 32
    return q, mu, b + 2


def barrett_mulmod(a, b, q, mu, shift) -> torch.Tensor:
    """a*b mod q for a, b < q < 2**30 by Barrett reduction: the quotient
    estimate t = ((a*b >> (bitlen(q)-1)) * mu) >> shift undershoots by at
    most 2, so two conditional subtracts finish.  Every intermediate stays
    below 2**63."""
    p = a.long() * b
    t = ((p >> (shift - 3)) * mu) >> shift
    r = p - t * q
    r = torch.where(r >= 2 * q, r - 2 * q, r)
    return torch.where(r >= q, r - q, r).int()


def shoup_mulmod(a, w, w_shoup, q) -> torch.Tensor:
    """a*w mod q for a constant w < q with w_shoup = floor(w * 2**32 / q)
    (uint32 bits; int32 or int64 storage).  `a` may be lazy, below 2**32
    (int64).  The high half of a*w_shoup is built from 16-bit pieces of a
    so no product reaches 2**63."""
    a = a.long()
    ws = w_shoup.long() & 0xFFFFFFFF
    hi = ((a >> 16) * ws + (((a & 0xFFFF) * ws) >> 16)) >> 16
    r = a * w - hi * q                        # in [0, 2q)
    return torch.where(r >= q, r - q, r).int()


def addmod(a, b, q) -> torch.Tensor:
    """a + b mod q for a, b < q."""
    r = a + b
    return torch.where(r >= q, r - q, r)


def submod(a, b, q) -> torch.Tensor:
    """a - b mod q for a, b < q."""
    r = a - b
    return torch.where(r < 0, r + q, r)


def negmod(a, q) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


def shoup_precompute(w, q) -> np.ndarray:
    """w' = floor(w * 2**32 / q) as uint32 (host numpy; w < q < 2**30, so
    w * 2**32 < 2**62 is exact in int64)."""
    w = np.asarray(w, np.int64)
    q = np.asarray(q, np.int64)
    return ((w << 32) // q).astype(np.uint32)
