"""Wrappers of the CUDA NTT kernels K1 (forward) and K2 (inverse), and
plain mirrors of their schedules.

Both kernels (`csrc/ntt.cu`) split a row over two blocks of n/64 threads
and keep each thread's 32 elements in registers through three radix-32
phases with two shared-memory exchanges: K1 after its first stage, K2
before its last, which pairs the halves through the distributed shared
memory of a 2-block cluster (rings below 2^11: one block per row, radix-2
stages in shared memory).  These wrappers check the tensors, launch on
PyTorch's current stream and count the launches.  The plain versions they
replace on the CPU are `ntt.fwd_plain` / `ntt.inv_plain`;
`fwd_phased_plain` and `inv_phased_plain` repeat the kernels' thread and
element mapping, twiddle indices, exchange addresses and stores in int64,
so the CPU tests hold the kernels' indexing against the reference.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import KERNEL_LAUNCHES
from . import cuda_build
from .modarith import addmod_plain, shoup_mulmod, submod_plain
from .ntt import NttTables, is_limb_map

# Each thread holds 32 elements of a half row in registers, n/64 threads a
# block, two blocks a row: at least one warp (n >= 2**11), and at 2**15
# 512 threads x 64 registers, so two blocks share an SM.  At 2**16 (the
# 128-bit preset's ring) a block has 1024 threads at the same register
# budget and fills an SM alone.  Below 2**11 (MIN_LOGN) the rows go to the
# one-block-per-row radix-2 kernels (`ntt_*_kernel_small`), whose schedule
# is the plain versions'.
MAX_LOGN = 16
MIN_LOGN = 11
SMALL_MIN_LOGN = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _lib():
    lib = cuda_build.library("ntt")
    if not getattr(lib, "_typed", False):
        for fn in (lib.ntt_forward, lib.ntt_inverse):
            fn.restype = _I
        lib.ntt_forward.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                    _P]
        lib.ntt_inverse.argtypes = [_P, _P, _P, _I, _I, _I, _LL, _I, _P, _P,
                                    _P, _P, _P, _P, _P, _P]
        lib._typed = True
    return lib


def check_ring(logn: int, lowest: int = SMALL_MIN_LOGN) -> None:
    """Raises unless K1/K2 are built for ring 2^logn (`lowest`: the
    smallest ring of the layout in question)."""
    if logn < lowest:
        raise ValueError(f"ring 2^{logn} is below K1/K2's 2^{lowest}")
    if logn > MAX_LOGN:
        raise ValueError(f"ring 2^{logn} is above K1/K2's 2^{MAX_LOGN}")


def _check(x: torch.Tensor, t: NttTables, L: int) -> int:
    check_ring(t.logn)
    if not x.is_cuda:
        raise ValueError("the CUDA NTT takes a CUDA tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"residues must be int32, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != t.n or x.shape[-2] != L:
        raise ValueError(f"shape {tuple(x.shape)} does not match n={t.n}, "
                         f"{L} limbs")
    if x.device != t.device:
        raise ValueError(f"tensor on {x.device}, tables on {t.device}")
    return x.numel() // t.n


def _limb_map(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    lmap = t.limb_map(limbs)
    D = lmap.shape[0]
    if is_limb_map(limbs) and (x.dim() < 3 or x.shape[0] != D):
        raise ValueError(f"a limb map of {D} entries needs a leading axis "
                         f"of {D}, got {tuple(x.shape)}")
    return lmap


def entry_stride(x: torch.Tensor) -> int:
    """The element stride between the (L, n) entries of x's leading axes,
    which must flatten to one axis, with rows n apart and the innermost
    axis contiguous (a limb slice of a contiguous tensor is); raises for
    any other layout."""
    n, L = x.shape[-1], x.shape[-2]
    if (n > 1 and x.stride(-1) != 1) or (L > 1 and x.stride(-2) != n):
        raise ValueError(f"rows must be contiguous and {n} elements apart, "
                         f"got strides {x.stride()}")
    stride = span = None
    for size, st in reversed(list(zip(x.shape[:-2], x.stride()[:-2]))):
        if size == 1:
            continue
        if stride is None:
            stride = span = st
        elif st != span:
            raise ValueError(f"leading axes of strides {x.stride()} do not "
                             f"flatten to one")
        span *= size
    return L * n if stride is None else stride


def fwd(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """Kernel K1.  `limbs`: a limb tuple, or a limb map with one tuple per
    entry of x's leading axis (an index < 0 skips its rows, which are left
    unwritten in the output)."""
    lmap = _limb_map(x, t, limbs)
    D, L = lmap.shape
    rows = _check(x, t, L)
    if not x.is_contiguous():
        raise ValueError("residues must be contiguous")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().ntt_forward(
            x.data_ptr(), out.data_ptr(), lmap.data_ptr(), D, rows // (D * L),
            L, t.logn, t.q.data_ptr(), t.psi_rev.data_ptr(),
            t.psi_rev_s.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ntt_forward launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["ntt_fwd"] += 1
    return out


def inv(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """Kernel K2, into a new contiguous tensor.  x may be a limb slice read
    in place (`entry_stride`); `limbs` as for `fwd`."""
    lmap = _limb_map(x, t, limbs)
    D, L = lmap.shape
    rows = _check(x, t, L)
    stride = entry_stride(x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().ntt_inverse(
            x.data_ptr(), out.data_ptr(), lmap.data_ptr(), D, rows // (D * L),
            L, stride, t.logn, t.q.data_ptr(), t.ipsi_rev.data_ptr(),
            t.ipsi_rev_s.data_ptr(), t.n_inv.data_ptr(), t.n_inv_s.data_ptr(),
            t.n_inv_w.data_ptr(), t.n_inv_ws.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ntt_inverse launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["ntt_inv"] += 1
    return out


# ---------------------------------------------------------------------------
# plain mirrors of the kernels' schedules


def _brev(v: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


class _Layout:
    """The indices both kernels share for one block of a row: `tid` (T, 1)
    with its warp, lane and phase-3 group g, `k` (1, 32) the register,
    the phase 1-2 twiddles of half c in shared memory, and the exchange
    addresses (`csrc/ntt.cu` header)."""

    def __init__(self, logn: int):
        check_ring(logn, MIN_LOGN)
        self.H = 1 << (logn - 1)
        self.T = self.M3 = self.H // 32
        self.S1 = self.SKEW = logn - 11
        self.tid = torch.arange(self.T)[:, None]
        self.warp, self.lane = self.tid >> 5, self.tid & 31
        self.k = torch.arange(32)[None, :]
        self.g = _brev(self.tid, logn - 6)
        self.line = 32 * self.warp + self.k

    def shared_twiddles(self, w, ws, c):
        """s_w[m + i] = w[(2 + c) m + i] for the m < T groups of phases 1-2
        (entry 0 unused)."""
        j = torch.arange(1, self.T)
        m = 1 << torch.floor(torch.log2(j.double())).long()
        sw, sws = torch.zeros_like(w[:, :self.T]), torch.zeros_like(w[:, :self.T])
        sw[:, 1:], sws[:, 1:] = w[:, j + (1 + c) * m], ws[:, j + (1 + c) * m]
        return sw, sws

    def buffer(self, rows):
        return torch.zeros(rows.shape[:-1] + (self.H + 32,), dtype=torch.int64)

    def phase1_addr(self):          # element tid + T k
        return self.tid + (self.T + 1) * self.k

    def phase2_addr(self):          # element 1024 warp + lane + 32 k
        return 32 * self.line + self.lane + (self.line >> self.SKEW)

    def phase3_addr(self):          # element 32 g + k
        return 32 * self.g + (self.g >> self.SKEW) + self.k


def _stage(a, s, base, tw, tws, q, inverse):
    """Stage s of a phase: a[k] pairs with a[k + (16 >> s)], twiddle
    base + (k >> (5 - s)) of table (tw, tws); Cooley-Tukey, or
    Gentleman-Sande if `inverse`."""
    hk = 16 >> s
    first = torch.tensor([i for i in range(32) if not i & hk])
    ti = base + (first[None, :] >> (5 - s))            # (T, 16)
    u, v = a[..., first], a[..., first + hk]
    w, ws = tw[:, ti], tws[:, ti]
    a = a.clone()
    if inverse:
        a[..., first] = addmod_plain(u, v, q)
        a[..., first + hk] = shoup_mulmod(u + q - v, w, ws, q).long()
    else:
        v = shoup_mulmod(v, w, ws, q).long()
        a[..., first] = addmod_plain(u, v, q)
        a[..., first + hk] = submod_plain(u, v, q)
    return a


def fwd_phased_plain(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """K1's schedule in plain int64, block by block: for each half c of a
    row, a (rows, threads, 32) tensor stands for the registers, `buf` for
    the exchange buffer (n/2 words and the skew's 32), `sw`/`sws` for the
    shared phase 1-2 twiddles.  Same stage-1 loads, phases, twiddle indices,
    exchange addresses (skew included) and store order as `csrc/ntt.cu`;
    the result equals `ntt.fwd_plain`."""
    lay = _Layout(t.logn)
    H, T, S1 = lay.H, lay.T, lay.S1
    tid, warp, k, g = lay.tid, lay.warp, lay.k, lay.g
    idx = t.index(limbs)
    L = len(limbs)
    q = t.q[idx].long().view(L, 1, 1)
    w = t.psi_rev[idx].long()
    ws = t.psi_rev_s[idx].long()
    rows = x.long().reshape(-1, L, t.n)
    out = torch.empty_like(rows)
    for c in (0, 1):
        sw, sws = lay.shared_twiddles(w, ws, c)
        u = rows[..., tid + T * k]                         # stage 1
        v = shoup_mulmod(rows[..., H + tid + T * k], w[:, 1, None, None],
                         ws[:, 1, None, None], q).long()
        a = submod_plain(u, v, q) if c else \
            addmod_plain(u, v, q)                          # (R, L, T, 32)
        for s in range(S1):
            a = _stage(a, s, 1 << s, sw, sws, q, False)
        buf = lay.buffer(rows)
        buf[..., lay.phase1_addr()] = a                    # exchange 1
        a = buf[..., lay.phase2_addr()]
        for s in range(5):
            a = _stage(a, s, (1 << (S1 + s)) + (warp << s), sw, sws, q, False)
        buf[..., lay.phase2_addr()] = a                    # exchange 2
        a = buf[..., lay.phase3_addr()]
        b3 = (2 + c) * lay.M3 + g
        for s in range(5):
            a = _stage(a, s, b3 << s, w, ws, q, False)
        out[..., 2 * (_brev(k, 5) * T + tid) + c] = a      # the store
    return out.reshape(x.shape).int()


def inv_phased_plain(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """K2's schedule in plain int64: for each half c, the parity-c load,
    phases 3, 2, 1 with the Gentleman-Sande butterflies, the exchanges at
    K1's addresses, then the last stage as the kernel splits it across the
    cluster (each block's 16 given elements per thread written at the
    addresses it read, the partner's read back, n^-1 folded into the two
    per-prime constants).  The result equals `ntt.inv_plain`."""
    lay = _Layout(t.logn)
    H, T, S1 = lay.H, lay.T, lay.S1
    tid, warp, k, g = lay.tid, lay.warp, lay.k, lay.g
    idx = t.index(limbs)
    L = len(limbs)
    q = t.q[idx].long().view(L, 1, 1)
    w = t.ipsi_rev[idx].long()
    ws = t.ipsi_rev_s[idx].long()
    rows = x.long().reshape(-1, L, t.n)
    halves, bufs = [], []
    for c in (0, 1):
        sw, sws = lay.shared_twiddles(w, ws, c)
        a = rows[..., 2 * (_brev(k, 5) * T + tid) + c]     # (R, L, T, 32)
        b3 = (2 + c) * lay.M3 + g
        for s in reversed(range(5)):                       # phase 3
            a = _stage(a, s, b3 << s, w, ws, q, True)
        buf = lay.buffer(rows)
        buf[..., lay.phase3_addr()] = a                    # exchange 1
        a = buf[..., lay.phase2_addr()]
        for s in reversed(range(5)):                       # phase 2
            a = _stage(a, s, (1 << (S1 + s)) + (warp << s), sw, sws, q, True)
        buf[..., lay.phase2_addr()] = a                    # exchange 2
        a = buf[..., lay.phase1_addr()]
        for s in reversed(range(S1)):                      # phase 1
            a = _stage(a, s, 1 << s, sw, sws, q, True)
        kept = slice(16 * c, 16 * c + 16)
        given = slice(16 * (1 - c), 16 * (1 - c) + 16)
        buf[..., lay.phase1_addr()[:, :16]] = a[..., given]
        halves.append(a[..., kept])
        bufs.append(buf)
    s0 = t.n_inv[idx].view(L, 1, 1), t.n_inv_s[idx].view(L, 1, 1)
    s1 = t.n_inv_w[idx].view(L, 1, 1), t.n_inv_ws[idx].view(L, 1, 1)
    out = torch.empty_like(rows)
    for c in (0, 1):
        peer = bufs[1 - c][..., lay.phase1_addr()[:, :16]]
        u, v = (peer, halves[c]) if c else (halves[c], peer)
        p = tid + T * (16 * c + k[:, :16])
        out[..., p] = shoup_mulmod(u + v, *s0, q).long()
        out[..., p + H] = shoup_mulmod(u + q - v, *s1, q).long()
    return out.reshape(x.shape).int()
