"""CKKS canonical-embedding encode/decode (host numpy, float64).

A copy of the JAX package's encoder.  Slot t lives at the evaluation
point zeta^(5^t) (zeta a primitive 2N-th complex root), its conjugate
partner at zeta^(-5^t), so real slot vectors produce real coefficient
vectors and the Galois automorphism X -> X^(5^r) rotates slots cyclically.
Encode returns exact int64 coefficients (after scaling and rounding); the
RNS spread and forward NTT happen in the evaluator.
"""

from __future__ import annotations

import numpy as np
import torch

# bound on |torch's scaled coefficient - numpy's| over scale * max|z|: both
# float64 FFTs err by at most about log2(n) * eps * max|z| * scale
# (1.7e-15 at n = 2^15) on any coefficient; 300x that
_FFT_GAP = 1e-12


class Encoder:
    def __init__(self, n: int):
        self.n = n
        self.slots = n // 2
        two_n = 2 * n
        g = np.empty(self.slots, np.int64)
        cur = 1
        for t in range(self.slots):
            g[t] = cur
            cur = cur * 5 % two_n
        self.rot_group = g
        self.k_fwd = (g - 1) // 2                      # slot t -> eval index
        g_conj = two_n - g
        self.k_conj = (g_conj - 1) // 2
        j = np.arange(n)
        self.zeta_j = np.exp(1j * np.pi * j / n)       # zeta^j
        self.zeta_mj = np.conj(self.zeta_j)

    def encode(self, z: np.ndarray, scale: float) -> np.ndarray:
        """Real/complex slot vector (<= slots entries) -> int64 coeffs (n,)."""
        z = np.asarray(z, np.complex128)
        full = np.zeros(self.slots, np.complex128)
        full[: z.shape[0]] = z
        E = np.zeros(self.n, np.complex128)
        E[self.k_fwd] = full
        E[self.k_conj] = np.conj(full)
        # m_j = (1/n) * zeta^-j * FFT(E)_j ; real by conjugate symmetry
        m = np.fft.fft(E) * self.zeta_mj / self.n
        coeffs = np.rint(np.real(m) * scale)
        assert np.max(np.abs(coeffs)) < 2 ** 62, "encode overflow"
        return coeffs.astype(np.int64)

    def encode_many(self, Z, scale: float, device) -> torch.Tensor:
        """encode() of each row of Z (R, <= slots; an array, or a tensor
        on `device`) as (R, n) int64 on `device`, by torch's float64 FFT
        there.  A row with a scaled coefficient closer to a half-integer
        than the two FFTs can differ is encoded by encode() instead, so
        every row is encode()'s to the bit."""
        Z = torch.as_tensor(Z, device=device)
        full = torch.zeros((Z.shape[0], self.slots), dtype=torch.complex128,
                           device=device)
        full[:, : Z.shape[1]] = Z
        E = torch.zeros((Z.shape[0], self.n), dtype=torch.complex128,
                        device=device)
        E[:, torch.as_tensor(self.k_fwd, device=device)] = full
        E[:, torch.as_tensor(self.k_conj, device=device)] = full.conj()
        zeta = torch.as_tensor(self.zeta_mj, device=device)
        v = (torch.fft.fft(E) * zeta / self.n).real * scale
        del E, full
        out = torch.round(v)                            # half to even: rint
        assert float(out.abs().max()) < 2 ** 62, "encode overflow"
        gap = _FFT_GAP * scale * float(Z.abs().max())
        near = ((v - torch.floor(v) - 0.5).abs() <= gap).any(1)
        out = out.long()
        for r in torch.nonzero(near).flatten().tolist():
            out[r] = torch.as_tensor(self.encode(Z[r].cpu().numpy(), scale),
                                     device=device)
        return out

    def decode(self, coeffs: np.ndarray, scale: float) -> np.ndarray:
        """Centered integer coeffs (n,) -> complex slot values (slots,)."""
        m = np.asarray(coeffs, np.float64)
        E = self.n * np.fft.ifft(m * self.zeta_j)
        return E[self.k_fwd] / scale


def crt_lift_center(residues: np.ndarray, primes) -> np.ndarray:
    """Centered CRT reconstruction of (L, n) residues with exact Python
    ints, returned as float64 (the value the decoder consumes): the plain
    version of the native lifter `io/native.crt_lift_center`, and its path
    at Q >= 2^120."""
    Q = 1
    for q in primes:
        Q *= int(q)
    acc = np.zeros(residues.shape[-1], dtype=object)
    for i, q in enumerate(primes):
        qi = int(q)
        Qi = Q // qi
        w = Qi * pow(Qi % qi, qi - 2, qi)
        acc = (acc + residues[i].astype(np.int64).astype(object) * w) % Q
    acc = np.where(acc > Q // 2, acc - Q, acc)
    return acc.astype(np.float64)
