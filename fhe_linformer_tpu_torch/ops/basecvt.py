"""Fused RNS digit fold + fast base conversion: the CUDA kernel K3's wrapper,
its plain PyTorch version, and a plain mirror of the kernel's arithmetic.

For every hybrid key-switch digit j (a group of alpha source limbs) and
every target prime p:

    y[j, ..., p, :] = sum_{t in group j} (x[t] * fold[t] mod q_t)
                      * conv[t, p]  mod p

The decomposition (Q_l -> Q_l u P) and the mod-down conversion (P -> Q_l,
`prefolded=True`, nd = 1) of every key switch run through here.  Tables
are a `ckks.context.BCTables`.  Source rows past x.shape[-2] (a partly
filled last digit group) count as zero, so callers pass only the active
limbs.  A CUDA tensor goes to `csrc/basecvt.cu`, which computes the sums as
int8 digit-plane products on the tensor cores; a CPU tensor to the plain
int64 version.  `base_convert_planes_plain` repeats the kernel's digit
planes, fragment tables and epilogue in int64, so the CPU tests hold the
tables and their layout against the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.timing import KERNEL_LAUNCHES
from . import cuda_build
from .modarith import addmod, shoup_mulmod

# The paired planes P0 + 256 P1 stay below 2**30 only while
# 257 * 128**2 * 4 alpha < 2**30, i.e. alpha <= 63 (csrc/basecvt.cu).
MAX_ALPHA = 63
TILE = 256              # coefficients per block tile: n must be a multiple

_P = ctypes.c_void_p
_I = ctypes.c_int


def base_convert(x: torch.Tensor, bc, prefolded: bool = False) -> torch.Tensor:
    """x: (..., g, N) int32 with g <= bc.nd * bc.alpha.  Returns
    (nd, ..., tgt, N) int32."""
    if x.is_cuda:
        return base_convert_cuda(x.contiguous(), bc, prefolded)
    return base_convert_plain(x, bc, prefolded)


def base_convert_plain(x: torch.Tensor, bc, prefolded: bool = False
                       ) -> torch.Tensor:
    g_valid = x.shape[-2]
    w = x if prefolded else shoup_mulmod(x, bc.fold[:g_valid, None],
                                         bc.fold_s[:g_valid, None],
                                         bc.gq[:g_valid, None])
    q = bc.q_out[:, None].long()
    outs = []
    for j in range(bc.nd):
        acc = torch.zeros(x.shape[:-2] + (bc.q_out.shape[0], x.shape[-1]),
                          dtype=torch.int64, device=x.device)
        for g in range(j * bc.alpha, min((j + 1) * bc.alpha, g_valid)):
            acc += w[..., g:g + 1, :].long() * bc.conv[g][:, None] % q
        outs.append((acc % q).int())
    return torch.stack(outs)


# Fragment layout of mma.m16n8k32 .s8 (PTX ISA, "Matrix fragments for
# mma.m16n8k32"): lane = 4 * group + tig holds A words r = 0..3 at row
# group + 8 * (r & 1), columns 4 * tig + 16 * (r >> 1) + byte; B words
# 0/1 at rows (k) 4 * tig + 16 * word + byte, column group; C registers
# i = 0..3 at row group + 8 * (i >> 1), column 2 * tig + (i & 1).
def fragment_rows_cols():
    """(rows, cols) of the A fragment: rows (32, 4) per (lane, word), cols
    (32, 4, 4) per (lane, word, byte)."""
    lane = np.arange(32)
    group, tig = lane >> 2, lane & 3
    r = np.arange(4)
    rows = group[:, None] + 8 * (r[None, :] & 1)
    cols = (4 * tig[:, None, None] + 16 * (r[None, :, None] >> 1)
            + np.arange(4)[None, None, :])
    return rows, cols


def balanced_digits(v: np.ndarray) -> np.ndarray:
    """(4,) + v.shape balanced base-256 digits of v < 2**30: the low three
    in [-128, 128), the top one in [0, 64]."""
    out = []
    for _ in range(4):
        u = v & 255
        d = np.where(u >= 128, u - 256, u)
        out.append(d)
        v = (v - d) >> 8
    assert (v == 0).all()
    return np.stack(out)


def plane_fragments(conv, q_out, nd: int, alpha: int) -> np.ndarray:
    """Kernel K3's A operand: (nd, RB, 2, KS, 32, 4) uint32 words, RB =
    ceil(tgt/8) blocks of 8 targets, KS = ceil(alpha/8) k-steps of 32.
    m-tile (rb, h) has rows 0-7 = plane 2h and rows 8-15 = plane 2h + 1 of
    targets 8 rb .. 8 rb + 7; k-step s has columns K = 32 s + 4 t' + e2
    for source t = 8 s + t' and digit e2."""
    conv = np.asarray(conv, np.int64)
    q = np.asarray(q_out, np.int64)
    tgt = q.shape[0]
    rbs, ks = -(-tgt // 8), -(-alpha // 8)
    cv = conv.reshape(nd, alpha, tgt).transpose(0, 2, 1)   # (nd, tgt, alpha)
    C = np.zeros((nd, 8 * rbs, 8 * ks, 4), np.int64)
    for e2 in range(4):
        C[:, :tgt, :alpha, e2] = (cv << (8 * e2)) % q[None, :, None]
    D = balanced_digits(C)                                 # (4, nd, P, T, 4)
    rows, cols = fragment_rows_cols()
    j = np.arange(nd)[:, None, None, None, None, None, None]
    rb = np.arange(rbs)[None, :, None, None, None, None, None]
    h = np.arange(2)[None, None, :, None, None, None, None]
    s = np.arange(ks)[None, None, None, :, None, None, None]
    rho = rows[None, None, None, None, :, :, None]
    k = 32 * s + cols[None, None, None, None]
    vals = D[2 * h + (rho >> 3), j, 8 * rb + (rho & 7), k >> 2, k & 3]
    return ((vals & 255) << (8 * np.arange(4))).sum(-1).astype(np.uint32)


def _s8_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., 4) signed bytes of uint32 words (int64), lowest byte first."""
    b = (words.long()[..., None] >> (8 * torch.arange(4))) & 255
    return torch.where(b >= 128, b - 256, b)


def base_convert_planes_plain(x: torch.Tensor, bc, prefolded: bool = False
                              ) -> torch.Tensor:
    """Kernel K3's arithmetic in plain int64: balanced base-256 digits of
    the folded operand as (w + 0x808080) ^ 0x808080, the A operand rebuilt
    from `bc.planes` by the mma.m16n8k32 fragment layout, one s8 product
    per digit, then the paired-plane epilogue with `bc.rowc`.  Equals
    `base_convert_plain`."""
    g_valid, n = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    nd, alpha = bc.nd, bc.alpha
    _, rbs, _, ks, _, _ = bc.planes.shape
    tgt = bc.q_out.shape[0]
    w = x if prefolded else shoup_mulmod(x, bc.fold[:g_valid, None],
                                         bc.fold_s[:g_valid, None],
                                         bc.gq[:g_valid, None])
    w = w.long().reshape(-1, g_valid, n)
    # B operand: K = 4 t + e2 over the digit's 8 ks (zero-padded) sources
    src = torch.zeros((w.shape[0], nd, 8 * ks, n), dtype=torch.int64)
    for j in range(nd):
        lo, hi = j * alpha, min((j + 1) * alpha, g_valid)
        src[:, j, :hi - lo] = w[:, lo:hi]
    digits = _s8_bytes((src + 0x808080) ^ 0x808080)        # (B, nd, T, n, 4)
    bmat = digits.transpose(-1, -2).reshape(w.shape[0], nd, 32 * ks, n)
    # A operand: (nd, rbs, 2, 16, 32 ks) from the fragment words
    rows, cols = fragment_rows_cols()
    rows = torch.from_numpy(rows)[:, :, None].expand(32, 4, 4)
    cols = torch.from_numpy(cols)
    frag = _s8_bytes(bc.planes)                  # (nd, rbs, 2, ks, 32, 4, 4)
    amat = torch.zeros((nd, rbs, 2, 16, 32 * ks), dtype=torch.int64)
    for s in range(ks):
        amat[:, :, :, rows, 32 * s + cols] = frag[:, :, :, s]
    prod = torch.einsum("jrhmk,bjkn->bjrhmn", amat, bmat)  # exact in int64
    p01 = prod[:, :, :, 0, :8] + 256 * prod[:, :, :, 0, 8:]
    p23 = prod[:, :, :, 1, :8] + 256 * prod[:, :, :, 1, 8:]
    p01, p23 = (p.reshape(w.shape[0], nd, 8 * rbs, n)[:, :, :tgt]
                for p in (p01, p23))
    assert max(p01.abs().max(), p23.abs().max()) < 2 ** 30
    rowc = (bc.rowc.long() & 0xFFFFFFFF)[:, :, None]       # (5, tgt, 1)
    q, bias, sh1, p16, p16_s = rowc
    x01 = (p01 + bias) & 0xFFFFFFFF                        # the u32 sums
    x23 = (p23 + bias) & 0xFFFFFFFF
    y = addmod(shoup_mulmod(x01, torch.ones_like(q), sh1, q).long(),
               shoup_mulmod(x23, p16, p16_s, q).long(), q)
    return y.transpose(0, 1).reshape((nd,) + lead + (tgt, n)).int()


def _lib():
    lib = cuda_build.library("basecvt")
    if not getattr(lib, "_typed", False):
        lib.base_convert.restype = _I
        lib.base_convert.argtypes = [_P] * 7 + [_I] * 7 + [_P]
        lib._typed = True
    return lib


def base_convert_cuda(x: torch.Tensor, bc, prefolded: bool = False
                      ) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError("the CUDA base conversion takes a CUDA tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"residues must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("residues must be contiguous")
    g_valid, n = x.shape[-2], x.shape[-1]
    if g_valid > bc.nd * bc.alpha:
        raise ValueError(f"{g_valid} source rows exceed nd*alpha = "
                         f"{bc.nd * bc.alpha}")
    if bc.alpha > MAX_ALPHA:
        raise ValueError(f"alpha {bc.alpha} exceeds the kernel's exactness "
                         f"limit {MAX_ALPHA}")
    if n % TILE:
        raise ValueError(f"n = {n} is not a multiple of the kernel's "
                         f"{TILE}-coefficient tile")
    if x.device != bc.planes.device:
        raise ValueError(f"tensor on {x.device}, tables on {bc.planes.device}")
    lead = x.shape[:-2]
    batch = x.numel() // (g_valid * n) if x.numel() else 0
    if batch >= 65536:
        raise ValueError(f"batch {batch} exceeds the grid's z dimension")
    tgt = bc.q_out.shape[0]
    out = torch.empty((bc.nd,) + lead + (tgt, n), dtype=torch.int32,
                      device=x.device)
    if batch == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().base_convert(
            x.data_ptr(), out.data_ptr(), bc.planes.data_ptr(),
            bc.rowc.data_ptr(), bc.fold.data_ptr(), bc.fold_s.data_ptr(),
            bc.gq.data_ptr(), batch, g_valid, bc.nd, bc.alpha, tgt, n,
            int(prefolded), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"base_convert launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["base_convert"] += 1
    return out
