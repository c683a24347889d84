"""Host-side linear-transform factorization for CKKS bootstrapping (numpy
and scipy; a copy of the JAX package's `boot/transform.py`).

CoeffsToSlots / SlotsToCoeffs apply the special FFT that maps ring
coefficients to canonical-embedding slots.  Each radix-2 butterfly stage
of the special FFT (rotation-group twiddles, bit-reversed input) is built
as a sparse matrix; consecutive stages multiply into `level_budget` group
matrices; each group is then re-expressed as generalized diagonals for
BSGS evaluation (linalg/packed.bsgs_diag_transform).
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import csr_matrix


def _rot_group(n: int) -> np.ndarray:
    M = n // 2
    g = np.empty(M, np.int64)
    cur = 1
    for t in range(M):
        g[t] = cur
        cur = cur * 5 % (2 * n)
    return g


def _bit_rev_perm(M: int) -> np.ndarray:
    bits = M.bit_length() - 1
    idx = np.arange(M)
    out = np.zeros(M, np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


def special_fft_stages(n: int):
    """Sparse stage matrices S_1..S_L (and the input bit-reversal perm P)
    such that  encode_fft(v) = S_L @ ... @ S_1 @ P @ v  reproduces the
    in-place special-FFT butterfly algorithm on M = n/2 slots."""
    M = n // 2
    rot = _rot_group(n)
    zeta = np.exp(1j * np.pi * np.arange(2 * n) / n)   # zeta^j, order 2n
    perm = _bit_rev_perm(M)
    P = csr_matrix((np.ones(M), (np.arange(M), perm)), shape=(M, M))
    stages = []
    length = 2
    while length <= M:
        rows, cols, vals = [], [], []
        lenh = length >> 1
        lenq = length << 2
        gap = 2 * n // lenq
        for i in range(0, M, length):
            for j in range(lenh):
                w = zeta[(rot[j] % lenq) * gap]
                a, b = i + j, i + j + lenh
                rows += [a, a, b, b]
                cols += [a, b, a, b]
                vals += [1.0, w, 1.0, -w]
        stages.append(csr_matrix((np.asarray(vals, np.complex128),
                                  (rows, cols)), shape=(M, M)))
        length <<= 1
    return P, stages


def special_ifft_stages(n: int):
    """Inverse: v = P^-1 @ S_1^-1 @ ... @ S_L^-1 @ x, with each stage
    inverse again a 2-nnz/row sparse butterfly (and 1/M folded in)."""
    M = n // 2
    rot = _rot_group(n)
    zeta = np.exp(1j * np.pi * np.arange(2 * n) / n)
    stages = []
    length = M
    while length >= 2:
        rows, cols, vals = [], [], []
        lenh = length >> 1
        lenq = length << 2
        gap = 2 * n // lenq
        for i in range(0, M, length):
            for j in range(lenh):
                wi = np.conj(zeta[(rot[j] % lenq) * gap])
                a, b = i + j, i + j + lenh
                # inverse butterfly: u=(x_a+x_b)/2 ; v=(x_a-x_b)*conj(w)/2
                rows += [a, a, b, b]
                cols += [a, b, a, b]
                vals += [0.5, 0.5, 0.5 * wi, -0.5 * wi]
        stages.append(csr_matrix((np.asarray(vals, np.complex128),
                                  (rows, cols)), shape=(M, M)))
        length >>= 1
    perm = _bit_rev_perm(M)
    stages.append(csr_matrix((np.ones(M), (perm, np.arange(M))),
                             shape=(M, M)))
    return stages


def group_stages(mats: list, budget: int) -> list:
    """Multiply consecutive sparse stages into `budget` group matrices
    (applied left-to-right: out = G_budget @ ... @ G_1 @ v)."""
    k = len(mats)
    sizes = [k // budget + (1 if i < k % budget else 0) for i in range(budget)]
    groups = []
    pos = 0
    for s in sizes:
        g = mats[pos]
        for m in mats[pos + 1: pos + s]:
            g = m @ g
        groups.append(g)
        pos += s
    return groups


def diagonals_of(mat: csr_matrix) -> dict[int, np.ndarray]:
    """Generalized-diagonal decomposition: diag k holds entries
    (i, (i+k) mod M), keyed in the order the entries first meet each
    diagonal (row-major), the form BSGS evaluation consumes."""
    M = mat.shape[0]
    coo = mat.tocoo()
    k = (coo.col.astype(np.int64) - coo.row) % M
    keys, first = np.unique(k, return_index=True)
    out: dict[int, np.ndarray] = {}
    for kk in keys[np.argsort(first)]:
        out[int(kk)] = np.zeros(M, np.complex128)
    for kk in keys:
        sel = k == kk
        out[int(kk)][coo.row[sel]] = coo.data[sel]
    return out


def encode_matrix_dense(n: int) -> np.ndarray:
    """Dense oracle (tests only, small n): the product of the special-FFT
    stages and the bit-reversal, S_L @ ... @ S_1 @ P, as one M x M
    matrix."""
    P, stages = special_fft_stages(n)
    acc = P.toarray().astype(np.complex128)
    for s in stages:
        acc = s.toarray() @ acc
    return acc
