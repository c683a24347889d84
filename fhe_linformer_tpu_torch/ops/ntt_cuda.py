"""Wrappers of the CUDA NTT kernels K1 (forward) and K2 (inverse), and a
plain mirror of K1's schedule.

K1 (`csrc/ntt.cu` `ntt_fwd_kernel`) runs two blocks per row, one per half
after the first stage, and keeps each thread's 32 elements in registers
through three radix-32 phases with two shared-memory exchanges;
K2 runs one thread block per residue row with the whole row in shared
memory.  These wrappers check the tensors, launch on PyTorch's current
stream and count the launches.  The plain versions they replace on the CPU
are `ntt.fwd_plain` / `ntt.inv_plain`; `fwd_phased_plain` repeats K1's
thread/element mapping, twiddle indices and exchanges in int64, so the CPU
tests hold the kernel's indexing against the reference.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import KERNEL_LAUNCHES
from . import cuda_build
from .modarith import addmod, shoup_mulmod, submod
from .ntt import NttTables, is_limb_map

# K2 holds a row in one block's shared memory: 2**15 u32 = 128 KB of the
# 227 KB a block may use.  Ring 2**16 rows (256 KB) do not fit, and K1 is
# instantiated up to the same size.  K1 gives each of n/64 threads 32
# elements of a half row and needs at least one warp (n >= 2**11).
MAX_LOGN = 15
MIN_LOGN_FWD = 11

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = cuda_build.library("ntt")
    if not getattr(lib, "_typed", False):
        for fn in (lib.ntt_forward, lib.ntt_inverse):
            fn.restype = _I
        lib.ntt_forward.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                                    _P]
        lib.ntt_inverse.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P,
                                    _P, _P]
        lib._typed = True
    return lib


def _check(x: torch.Tensor, t: NttTables, L: int) -> int:
    if not x.is_cuda:
        raise ValueError("the CUDA NTT takes a CUDA tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"residues must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("residues must be contiguous")
    if x.dim() < 2 or x.shape[-1] != t.n or x.shape[-2] != L:
        raise ValueError(f"shape {tuple(x.shape)} does not match n={t.n}, "
                         f"{L} limbs")
    if t.logn > MAX_LOGN:
        raise ValueError(f"ring 2^{t.logn} rows do not fit one thread "
                         f"block's shared memory (max 2^{MAX_LOGN})")
    if x.device != t.device:
        raise ValueError(f"tensor on {x.device}, tables on {t.device}")
    return x.numel() // t.n


def fwd(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """Kernel K1.  `limbs`: a limb tuple, or a limb map with one tuple per
    entry of x's leading axis (an index < 0 skips its rows, which are left
    unwritten in the output)."""
    lmap = t.limb_map(limbs)
    D, L = lmap.shape
    rows = _check(x, t, L)
    if t.logn < MIN_LOGN_FWD:
        raise ValueError(f"ring 2^{t.logn} is below K1's 2^{MIN_LOGN_FWD}")
    if is_limb_map(limbs) and (x.dim() < 3 or x.shape[0] != D):
        raise ValueError(f"a limb map of {D} entries needs a leading axis "
                         f"of {D}, got {tuple(x.shape)}")
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
    rows = _check(x, t, len(limbs))
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rl = t.row_limbs(limbs, rows)
    with torch.cuda.device(x.device):
        rc = _lib().ntt_inverse(
            x.data_ptr(), out.data_ptr(), rl.data_ptr(), rows, t.logn,
            t.q.data_ptr(), t.ipsi_rev.data_ptr(), t.ipsi_rev_s.data_ptr(),
            t.n_inv.data_ptr(), t.n_inv_s.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ntt_inverse launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["ntt_inv"] += 1
    return out


def _brev(v: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(v)
    for b in range(bits):
        out |= ((v >> b) & 1) << (bits - 1 - b)
    return out


def fwd_phased_plain(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    """K1's schedule in plain int64, block by block: for each half c of a
    row, a (rows, threads, 32) tensor stands for the registers, `buf` for
    the exchange buffer (n/2 words and the skew's 32), `sw`/`sws` for the
    shared phase 1-2 twiddles.  Same stage-1 loads, phases, twiddle indices,
    exchange addresses (skew included) and store order as `csrc/ntt.cu`;
    the result equals `ntt.fwd_plain`."""
    n, logn = t.n, t.logn
    if logn < MIN_LOGN_FWD:
        raise ValueError(f"ring 2^{logn} is below K1's 2^{MIN_LOGN_FWD}")
    H = n // 2
    T = M3 = H // 32
    S1 = SKEW = logn - 11
    idx = t.index(limbs)
    L = len(limbs)
    q = t.q[idx].long().view(L, 1, 1)
    w = t.psi_rev[idx].long()
    ws = t.psi_rev_s[idx].long()
    rows = x.long().reshape(-1, L, n)
    out = torch.empty_like(rows)
    tid = torch.arange(T)[:, None]
    warp, lane = tid >> 5, tid & 31
    k = torch.arange(32)[None, :]
    g = _brev(tid, logn - 6)
    j = torch.arange(1, T)
    m = 1 << torch.floor(torch.log2(j.double())).long()

    def stage(a, s, base, tw, tws):
        """Stage s of a phase: a[k] pairs with a[k + (16 >> s)], twiddle
        base + (k >> (5 - s)) of table (tw, tws)."""
        hk = 16 >> s
        first = torch.tensor([i for i in range(32) if not i & hk])
        ti = base + (first[None, :] >> (5 - s))            # (T, 16)
        u = a[..., first]
        v = shoup_mulmod(a[..., first + hk], tw[:, ti], tws[:, ti], q).long()
        a = a.clone()
        a[..., first] = addmod(u, v, q)
        a[..., first + hk] = submod(u, v, q)
        return a

    for c in (0, 1):
        sw = torch.zeros_like(w[:, :T])
        sws = torch.zeros_like(sw)
        sw[:, 1:], sws[:, 1:] = w[:, j + (1 + c) * m], ws[:, j + (1 + c) * m]
        u = rows[..., tid + T * k]                         # stage 1
        v = shoup_mulmod(rows[..., H + tid + T * k], w[:, 1, None, None],
                         ws[:, 1, None, None], q).long()
        a = submod(u, v, q) if c else addmod(u, v, q)      # (R, L, T, 32)
        for s in range(S1):
            a = stage(a, s, 1 << s, sw, sws)
        buf = torch.zeros(rows.shape[:-1] + (H + 32,), dtype=torch.int64)
        buf[..., tid + T * k] = a                          # exchange 1
        a = buf[..., 1024 * warp + lane + 32 * k]
        for s in range(5):
            a = stage(a, s, (1 << (S1 + s)) + (warp << s), sw, sws)
        line = 32 * warp + k                               # exchange 2
        buf[..., 32 * line + lane + (line >> SKEW)] = a
        a = buf[..., 32 * g + (g >> SKEW) + k]
        b3 = (2 + c) * M3 + g
        for s in range(5):
            a = stage(a, s, b3 << s, w, ws)
        out[..., 2 * (_brev(k, 5) * T + tid) + c] = a      # the store
    return out.reshape(x.shape).int()
