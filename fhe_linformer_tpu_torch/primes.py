"""NTT-friendly prime generation and primitive-root search.

A copy of the JAX package's `primes.py` (this package imports nothing from
it): the RNS limb primes satisfy q = 1 (mod 2N), so a primitive 2N-th root
of unity psi exists mod q (negacyclic NTT), and all primes stay below 2**30.
The modulus chains must come out identical to the JAX package's, including
the magnitude-matched interleave of `scaling_primes`.
"""

from __future__ import annotations

import functools
import math

# Deterministic Miller-Rabin witnesses for n < 3.3e24 (covers all u64).
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _factorize(n: int) -> list[int]:
    out = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def primitive_root(q: int) -> int:
    """Smallest primitive root of the multiplicative group mod prime q."""
    phi = q - 1
    facs = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in facs):
            return g
        g += 1


def root_of_unity(order: int, q: int) -> int:
    """A primitive `order`-th root of unity mod prime q (order | q-1)."""
    assert (q - 1) % order == 0, f"{order} does not divide {q}-1"
    g = primitive_root(q)
    psi = pow(g, (q - 1) // order, q)
    assert pow(psi, order // 2, q) == q - 1
    return psi


@functools.lru_cache(maxsize=None)
def ntt_primes(two_n: int, count: int, max_bits: int = 30,
               min_bits: int | None = None,
               descending: bool = True) -> tuple[int, ...]:
    """`count` distinct primes q = 1 (mod two_n), q < 2**max_bits, searched
    downward from 2**max_bits (largest first)."""
    lo = 1 << (min_bits if min_bits is not None else max_bits - 1)
    out = []
    q = ((1 << max_bits) - 2) // two_n * two_n + 1
    while len(out) < count and q > lo:
        if is_prime(q):
            out.append(q)
        q -= two_n
    if len(out) < count:
        raise ValueError(
            f"only found {len(out)} NTT primes = 1 mod {two_n} in "
            f"[2^{min_bits or max_bits - 1}, 2^{max_bits})")
    if not descending:
        out.reverse()
    return tuple(out)


@functools.lru_cache(maxsize=None)
def scaling_primes(two_n: int, count: int, scale_bits: int) -> tuple[int, ...]:
    """`count` primes = 1 mod two_n alternating tightly around
    2**scale_bits, so FLEXIBLEAUTO rescaling keeps the running scale pinned
    near the target."""
    target = 1 << scale_bits
    below, above = [], []
    q = target + 1 if (target % two_n == 0) else (target // two_n) * two_n + 1
    lo_q = q if q < target else q - two_n
    hi_q = lo_q + two_n
    while len(below) + len(above) < count:
        if hi_q < (1 << 30) and is_prime(hi_q):
            above.append(hi_q)
        if len(below) + len(above) < count and \
                lo_q > (1 << (scale_bits - 2)) and is_prime(lo_q):
            below.append(lo_q)
        hi_q += two_n
        lo_q -= two_n
    # Interleave above/below so consecutive rescales alternate the drift sign.
    out = []
    for i in range(count):
        src = above if (i % 2 == 0 and above) or not below else below
        out.append(src.pop(0))
    if max(out) / min(out) > 1.5:
        # Wide-spread pools: pair by matched log-deviation (most-positive
        # with most-negative) so adjacent primes multiply to ~target^2.
        devs = sorted(out, key=lambda q: math.log(q) - math.log(target))
        lo, hi = 0, len(devs) - 1
        seq = []
        while lo < hi:
            seq += [devs[hi], devs[lo]]
            hi -= 1
            lo += 1
        if lo == hi:
            seq.append(devs[lo])
        # leftover (odd count) sits at the chain bottom (dropped last)
        out = seq[::-1]
    return tuple(out)
