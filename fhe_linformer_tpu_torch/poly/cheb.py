"""Host-side Chebyshev series tools (plain float64 numpy; a copy of the
JAX package's `poly/cheb.py`).  The homomorphic evaluation is in eval.py."""

from __future__ import annotations

import numpy as np


def chebyshev_fit(f, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of f on [a, b] (degree+1 terms,
    basis T_0..T_degree in the variable mapped to [-1, 1])."""
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(
        f, degree, domain=[a, b])
    return cheb.coef


def cheb_eval(coeffs: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The T-basis series at y in [-1, 1] (the tests' oracle)."""
    return np.polynomial.chebyshev.chebval(y, coeffs)


def cheb_divmod(c: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Divide a T-basis series by T_m: c = q * T_m + r with deg(r) < m,
    using T_i = 2*T_(i-m)*T_m - T_|i-2m| for i > m."""
    c = np.array(c, np.float64)
    n = len(c) - 1
    assert m <= n
    q = np.zeros(n - m + 1)
    for i in range(n, m, -1):
        ci = c[i]
        if ci == 0.0:
            continue
        q[i - m] += 2.0 * ci
        c[abs(i - 2 * m)] -= ci
        c[i] = 0.0
    q[0] += c[m]
    c[m] = 0.0
    return q, c[:m]
