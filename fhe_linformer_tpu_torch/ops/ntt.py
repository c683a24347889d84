"""Negacyclic NTT tables and the plain PyTorch NTT / inverse NTT.

Convention (the JAX package's, so the outputs are bit-identical): for each
prime q with psi = root_of_unity(2n, q), the forward transform returns the
natural-order evaluations X[k] = x(psi^(2k+1)), and the inverse returns
coefficient order.  An exact NTT with the same psi and output order is
unique, so any correct algorithm matches the TPU's four-step int8 matmuls.

Algorithm (the butterfly network of the plain version here and of the CUDA
kernels K1/K2 in `csrc/ntt.cu`): forward is radix-2 Cooley-Tukey over
bit-reversed powers of psi, natural-order input to bit-reversed output,
with the bit-reversal folded into the read-out; inverse is Gentleman-Sande
over bit-reversed powers of psi^-1 from bit-reversed input, then a
multiply by n^-1.  K1 and K2 run the same butterflies in a different order
(`ntt_cuda.fwd_phased_plain` / `inv_phased_plain` mirror their schedules);
K2 folds n^-1 into its last stage.

`fwd` / `inv` take a CUDA tensor to the kernels (`ntt_cuda`) and a CPU
tensor to the plain int64 version below; `inv` hands a limb slice such as
`x[..., 1:, :]` to K2 as it is, which reads it in place.  `limbs` names,
for each row of the limb axis (-2), its index into the full basis the
tables cover, so a level's limb subset needs no table slicing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..primes import root_of_unity
from .modarith import addmod_plain, shoup_precompute, submod_plain


def _bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    out = np.zeros(n, np.int64)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


def pow_range(base: int, count: int, q: int) -> np.ndarray:
    """[base^0, ..., base^(count-1)] mod q (int64, vectorized)."""
    exps = np.arange(count, dtype=np.int64)
    out = np.ones(count, dtype=np.int64)
    b = base % q
    bit = 0
    while (1 << bit) < count:
        out = np.where((exps >> bit) & 1 == 1, out * b % q, out)
        b = b * b % q
        bit += 1
    return out


def _as_i32(a: np.ndarray) -> np.ndarray:
    """uint32 bit patterns stored in int32 lanes (the kernels read u32)."""
    return np.ascontiguousarray(a.astype(np.uint32)).view(np.int32)


class NttTables:
    """Per-prime twiddle tables over a fixed basis, on one device.

    psi_rev[l, i] = psi_l^bitrev(i) and ipsi_rev[l, i] = psi_l^-bitrev(i),
    each with its Shoup companion floor(w * 2**32 / q) (uint32 bits in
    int32 storage); n_inv per prime with its companion, and n_inv_w =
    ipsi_rev[:, 1] * n^-1 (the inverse's last twiddle with n^-1 folded in,
    kernel K2's constant) with its companion."""

    def __init__(self, n: int, qs, device):
        self.n = n
        self.logn = n.bit_length() - 1
        assert 1 << self.logn == n
        self.qs = tuple(int(q) for q in qs)
        L = len(self.qs)
        brv = _bitrev(n)
        fw = np.empty((L, n), np.int64)
        iw = np.empty((L, n), np.int64)
        for i, q in enumerate(self.qs):
            psi = root_of_unity(2 * n, q)
            fw[i] = pow_range(psi, n, q)[brv]
            iw[i] = pow_range(pow(psi, 2 * n - 1, q), n, q)[brv]
        qcol = np.asarray(self.qs, np.int64).reshape(-1, 1)
        ninv = np.asarray([pow(n, q - 2, q) for q in self.qs], np.int64)
        dev = lambda a: torch.from_numpy(a).to(device)
        self.q = dev(qcol[:, 0].astype(np.int32))
        self.device = self.q.device
        self.psi_rev = dev(fw.astype(np.int32))
        self.psi_rev_s = dev(_as_i32(shoup_precompute(fw, qcol)))
        self.ipsi_rev = dev(iw.astype(np.int32))
        self.ipsi_rev_s = dev(_as_i32(shoup_precompute(iw, qcol)))
        self.n_inv = dev(ninv.astype(np.int32))
        self.n_inv_s = dev(_as_i32(shoup_precompute(ninv, qcol[:, 0])))
        ninv_w = iw[:, 1] * ninv % qcol[:, 0]
        self.n_inv_w = dev(ninv_w.astype(np.int32))
        self.n_inv_ws = dev(_as_i32(shoup_precompute(ninv_w, qcol[:, 0])))
        self.brev = dev(brv)
        self._idx: dict[tuple, torch.Tensor] = {}
        self._maps: dict[tuple, torch.Tensor] = {}

    def index(self, limbs) -> torch.Tensor:
        """int64 device tensor of basis indices, cached per limb tuple."""
        key = tuple(limbs)
        if key not in self._idx:
            self._idx[key] = torch.tensor(key, dtype=torch.int64,
                                          device=self.device)
        return self._idx[key]

    def limb_map(self, limbs) -> torch.Tensor:
        """(D, L) int32 device tensor of basis indices for kernels K1/K2:
        one row for a limb tuple, one per leading-axis entry for a limb
        map."""
        key = tuple(map(tuple, limbs)) if is_limb_map(limbs) \
            else (tuple(limbs),)
        if key not in self._maps:
            self._maps[key] = torch.tensor(key, dtype=torch.int32,
                                           device=self.device)
        return self._maps[key]


def is_limb_map(limbs) -> bool:
    return len(limbs) > 0 and isinstance(limbs[0], (tuple, list))


def fwd(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """(..., L, n) int32 coefficients -> natural-order evaluations.

    `limbs` may also be a limb map: one tuple of L basis indices per entry
    of x's leading axis, where an index < 0 skips its rows (left unset in
    the output: zero here, unwritten by the kernel)."""
    if x.is_cuda:
        from . import ntt_cuda
        return ntt_cuda.fwd(x.contiguous(), t, limbs)
    if not is_limb_map(limbs):
        return fwd_plain(x, t, limbs)
    out = torch.zeros_like(x)
    for d, row in enumerate(limbs):
        sel = [i for i, limb in enumerate(row) if limb >= 0]
        out[d][..., sel, :] = fwd_plain(x[d][..., sel, :], t,
                                        [row[i] for i in sel])
    return out


def inv(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """(..., L, n) int32 evaluations -> contiguous coefficients.  On the
    card x may be a limb slice of a larger tensor (rows n apart, leading
    entries at one stride); K2 reads it in place."""
    if x.is_cuda:
        from . import ntt_cuda
        return ntt_cuda.inv(x, t, limbs)
    return inv_plain(x, t, limbs)


def fwd_plain(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """Plain int64 forward NTT: kernel K1's Cooley-Tukey stages, then the
    bit-reversed read-out.  A twiddle product (< 2**60) is reduced by an
    int64 remainder: the canonical residue K1's Shoup butterfly gives, in
    one operation instead of Shoup's eight."""
    n = t.n
    idx = t.index(limbs)
    q = t.q[idx].long().view(-1, 1, 1)
    w = t.psi_rev[idx].long()
    lead = x.shape[:-1]
    a = x.long()
    m, h = 1, n // 2
    while m < n:
        a = a.reshape(*lead, m, 2, h)
        u = a[..., 0, :]
        v = torch.remainder(a[..., 1, :] * w[:, m:2 * m, None], q)
        a = torch.stack((addmod_plain(u, v, q), submod_plain(u, v, q)),
                        dim=-2)
        m, h = 2 * m, h // 2
    return a.reshape(*lead, n)[..., t.brev].int()


def inv_plain(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """Plain int64 inverse NTT: kernel K2's Gentleman-Sande stages from
    the bit-reversed load, then the multiply by n^-1 (K2 folds it into its
    last stage).  Products are reduced by an int64 remainder, as in
    fwd_plain."""
    n = t.n
    idx = t.index(limbs)
    q = t.q[idx].long().view(-1, 1, 1)
    w = t.ipsi_rev[idx].long()
    lead = x.shape[:-1]
    a = x.long()[..., t.brev]
    m, h = n // 2, 1
    while m >= 1:
        a = a.reshape(*lead, m, 2, h)
        u = a[..., 0, :]
        v = a[..., 1, :]
        a = torch.stack((addmod_plain(u, v, q),
                         torch.remainder(submod_plain(u, v, q)
                                         * w[:, m:2 * m, None], q)), dim=-2)
        m, h = m // 2, 2 * h
    a = a.reshape(*lead, n)
    return torch.remainder(a * t.n_inv[idx].long().view(-1, 1),
                           q.view(-1, 1)).int()
