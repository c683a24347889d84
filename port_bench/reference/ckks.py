"""Plain decryption of the program's output ciphertexts (NumPy only).

The benchmark works out everything the judge needs from the configuration
and the run's seed alone: the RNS prime chain, the secret key, and the
slot values of a ciphertext.  It shares no code with the program.

Conventions the program's ciphertexts follow (its documented contract):
  * residues are (nl, n) over the first nl primes of the chain q_0, q_1, ...
    in the evaluation domain: X[k] = x(psi^(2k+1)) in natural order, with
    psi = g^((q-1)/2n) and g the smallest primitive root mod q;
  * the secret key is the sparse ternary vector drawn first from
    numpy's default_rng(key seed): secret_hw positions without repeats,
    then their signs;
  * slot t sits at the evaluation point zeta^(5^t mod 2n), zeta = e^(i pi/n),
    and the message is m = c0 + c1 * s at the ciphertext's scale.
"""

from __future__ import annotations

import math

import numpy as np

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


def primitive_root(q: int) -> int:
    phi, facs, d, m = q - 1, [], 2, q - 1
    while d * d <= m:
        if m % d == 0:
            facs.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        facs.append(m)
    g = 2
    while not all(pow(g, phi // f, q) != 1 for f in facs):
        g += 1
    return g


def _ntt_primes(two_n: int, count: int, max_bits: int) -> list[int]:
    """`count` primes = 1 mod two_n below 2^max_bits, largest first."""
    out, q = [], ((1 << max_bits) - 2) // two_n * two_n + 1
    while len(out) < count:
        if q <= 1 << (max_bits - 1):
            raise ValueError(f"too few {max_bits}-bit primes = 1 mod {two_n}")
        if is_prime(q):
            out.append(q)
        q -= two_n
    return out


def _scaling_primes(two_n: int, count: int, scale_bits: int) -> list[int]:
    """`count` primes = 1 mod two_n alternating around 2^scale_bits; a pool
    spread wider than 1.5x is reordered so neighbours pair by opposite
    log-deviation (the odd one out at the bottom of the chain)."""
    target = 1 << scale_bits
    below, above = [], []
    q = target + 1 if target % two_n == 0 else target // two_n * two_n + 1
    lo = q if q < target else q - two_n
    hi = lo + two_n
    while len(below) + len(above) < count:
        if hi < 1 << 30 and is_prime(hi):
            above.append(hi)
        if len(below) + len(above) < count and \
                lo > 1 << (scale_bits - 2) and is_prime(lo):
            below.append(lo)
        hi += two_n
        lo -= two_n
    out = []
    for i in range(count):
        src = above if (i % 2 == 0 and above) or not below else below
        out.append(src.pop(0))
    if max(out) / min(out) > 1.5:
        devs = sorted(out, key=lambda p: math.log(p) - math.log(target))
        i, j, seq = 0, len(devs) - 1, []
        while i < j:
            seq += [devs[j], devs[i]]
            j -= 1
            i += 1
        if i == j:
            seq.append(devs[i])
        out = seq[::-1]
    return out


def q_chain(ckks: dict) -> list[int]:
    """The q-limb primes of a configuration's `ckks` block: one headroom
    prime of first_mod_bits, then num_scaling primes near 2^scale_bits."""
    two_n = 2 * ckks["n"]
    alpha = (ckks["num_scaling"] + ckks["dnum"]) // ckks["dnum"]
    big = _ntt_primes(two_n, 1 + alpha, ckks["first_mod_bits"])
    return [big[0]] + _scaling_primes(two_n, ckks["num_scaling"],
                                      ckks["scale_bits"])


def secret_key(n: int, hw: int | None, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if hw is None:
        return rng.integers(-1, 2, n).astype(np.int64)
    s = np.zeros(n, np.int64)
    idx = rng.choice(n, hw, replace=False)
    s[idx] = rng.choice([-1, 1], hw)
    return s


def _powers(b: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, np.int64)
    out[0] = 1
    filled = 1
    step = b % q
    while filled < count:         # out[filled:2 filled] = out[:filled] b^filled
        k = min(filled, count - filled)
        out[filled:filled + k] = out[:k] * step % q
        filled += k
        step = step * step % q
    return out


def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def _cyclic(a: np.ndarray, w: int, q: int) -> np.ndarray:
    """A[k] = sum_i a[i] w^(ik) mod q, radix-2 decimation in time."""
    n = a.size
    a = a[_bitrev(n)]
    m = 1
    while m < n:
        tw = _powers(pow(w, n // (2 * m), q), m, q)
        a = a.reshape(-1, 2 * m)
        u, v = a[:, :m], a[:, m:] * tw % q
        a = np.concatenate([(u + v) % q, (u - v) % q], axis=1)
        m *= 2
    return a.reshape(n)


class Decryptor:
    """Decrypts ciphertexts of one configuration under the key of one seed."""

    def __init__(self, ckks: dict, key_seed: int):
        self.n = ckks["n"]
        self.qs = q_chain(ckks)
        self.s = secret_key(self.n, ckks.get("secret_hw"), key_seed)
        self._roots: dict[int, int] = {}
        self._s_eval: dict[int, np.ndarray] = {}

    def _psi(self, q: int) -> int:
        if q not in self._roots:
            psi = pow(primitive_root(q), (q - 1) // (2 * self.n), q)
            assert pow(psi, self.n, q) == q - 1
            self._roots[q] = psi
        return self._roots[q]

    def ntt(self, x: np.ndarray, q: int) -> np.ndarray:
        """Coefficients (n,) -> evaluations x(psi^(2k+1)), natural order."""
        psi = self._psi(q)
        twisted = np.asarray(x, np.int64) % q * _powers(psi, self.n, q) % q
        return _cyclic(twisted, psi * psi % q, q)

    def intt(self, X: np.ndarray, q: int) -> np.ndarray:
        ipsi = pow(self._psi(q), q - 2, q)
        a = _cyclic(np.asarray(X, np.int64) % q, ipsi * ipsi % q, q)
        n_inv = pow(self.n, q - 2, q)
        return a * _powers(ipsi, self.n, q) % q * n_inv % q

    def coefficients(self, c0: np.ndarray, c1: np.ndarray) -> np.ndarray:
        """The centred integer coefficients of c0 + c1 s, as float64, from
        (nl, n) evaluation-domain residues: exact CRT over all nl limbs."""
        nl = c0.shape[0]
        qs = self.qs[:nl]
        big_q = math.prod(qs)
        acc = np.zeros(self.n, dtype=object)
        for i, q in enumerate(qs):
            if i not in self._s_eval:
                self._s_eval[i] = self.ntt(self.s, q)
            m = (c0[i].astype(np.int64) % q
                 + c1[i].astype(np.int64) % q * self._s_eval[i]) % q
            coef = self.intt(m, q)
            qi = big_q // q
            acc = (acc + coef.astype(object) * (qi * pow(qi % q, q - 2, q))) \
                % big_q
        acc = np.where(acc > big_q // 2, acc - big_q, acc)
        return acc.astype(np.float64)

    def slots(self, c0, c1, scale: float, idx) -> np.ndarray:
        """Real parts of slots `idx` of the ciphertext (c0, c1) at `scale`."""
        m = self.coefficients(np.asarray(c0), np.asarray(c1))
        j = np.arange(self.n, dtype=np.int64)
        out = []
        for t in idx:
            g = pow(5, int(t), 2 * self.n)
            ang = np.pi * ((j * g) % (2 * self.n)) / self.n
            out.append(np.dot(m, np.cos(ang)) / scale)
        return np.asarray(out)
