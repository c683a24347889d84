"""Exact host reference (numpy int64 and Python ints) for the modular
primitives: the oracle the tests and `chip_smoke.py` hold results to.

A copy of the JAX package's `reference.py` (this package imports nothing
from it).  All arithmetic is exact: primes are below 2**30, so a product of
two residues is below 2**60 and fits int64.  Nothing here runs on the card
path: the port's own NTT is `ops/ntt.py` (plain int64 on the CPU, kernels
K1/K2 on the card), which must equal `NttPlan` limb by limb.
"""

from __future__ import annotations

import numpy as np

from .primes import root_of_unity


def bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class NttPlan:
    """Per-prime negacyclic NTT tables (natural order in, natural order out).

      fwd:  X[k] = sum_j x[j] * psi^(j*(2k+1)) mod q   (evaluation at psi^(2k+1))
      inv:  exact inverse.
    Multiplication in the transformed domain is negacyclic convolution in
    coefficient domain, i.e. multiplication in Z_q[X]/(X^N+1).
    """

    def __init__(self, n: int, q: int):
        self.n, self.q = n, q
        self.psi = root_of_unity(2 * n, q)
        self.psi_inv = pow(self.psi, 2 * n - 1, q)
        self.omega = self.psi * self.psi % q
        self.omega_inv = pow(self.omega, n - 1, q)
        self.n_inv = pow(n, q - 2, q)
        self.twist = np.array([pow(self.psi, t, q) for t in range(n)],
                              dtype=np.int64)
        self.untwist = np.array([pow(self.psi_inv, t, q) for t in range(n)],
                                dtype=np.int64)

    def _dft(self, y: np.ndarray, w: int) -> np.ndarray:
        """Iterative radix-2 Cooley-Tukey cyclic DFT_n with root w, exact."""
        n, q = self.n, self.q
        a = y[..., bit_reverse_perm(n)].astype(np.int64) % q
        length = 2
        while length <= n:
            wlen = pow(w, n // length, q)
            half = length // 2
            tw = np.empty(half, dtype=np.int64)
            acc = 1
            for i in range(half):
                tw[i] = acc
                acc = acc * wlen % q
            a = a.reshape(*a.shape[:-1], n // length, length)
            lo = a[..., :half]
            hi = a[..., half:] * tw % q
            a = np.concatenate([(lo + hi) % q, (lo - hi) % q], axis=-1)
            a = a.reshape(*a.shape[:-2], n)
            length *= 2
        return a

    def fwd(self, x: np.ndarray) -> np.ndarray:
        y = x.astype(np.int64) % self.q * self.twist % self.q
        return self._dft(y, self.omega)

    def inv(self, X: np.ndarray) -> np.ndarray:
        y = self._dft(X.astype(np.int64) % self.q, self.omega_inv)
        return y * self.n_inv % self.q * self.untwist % self.q


def negacyclic_mul_naive(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Schoolbook multiplication in Z_q[X]/(X^N+1); O(N^2), tests only."""
    n = a.shape[-1]
    a = a.astype(object)
    b = b.astype(object)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        if a[i] == 0:
            continue
        out[i:] += a[i] * b[: n - i]      # X^(i+j), i+j < n
        if i:
            out[:i] -= a[i] * b[n - i:]   # X^(i+j-n) wraps with sign flip
    return (out % q).astype(np.int64)


# ---------------------------------------------------------------------------
# RNS helpers (exact, arbitrary precision through Python ints)
# ---------------------------------------------------------------------------

def to_rns(x, qs) -> np.ndarray:
    """Integer (array) -> stacked residues, shape (len(qs), *x.shape)."""
    x = np.asarray(x, dtype=object)
    return np.stack([(x % q).astype(np.int64) for q in qs])


def from_rns(res: np.ndarray, qs) -> np.ndarray:
    """CRT-reconstruct to centered representatives in (-Q/2, Q/2], object dtype."""
    Q = 1
    for q in qs:
        Q *= int(q)
    acc = np.zeros(res.shape[1:], dtype=object)
    for r, q in zip(res, qs):
        Qi = Q // int(q)
        inv = pow(Qi % int(q), int(q) - 2, int(q))
        acc = (acc + r.astype(object) * inv % int(q) * Qi) % Q
    return np.where(acc > Q // 2, acc - Q, acc)
