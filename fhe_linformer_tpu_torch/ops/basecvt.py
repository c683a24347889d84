"""Fused RNS digit fold + fast base conversion: the CUDA kernel K3's wrapper
and its plain PyTorch version.

For every hybrid key-switch digit j (a group of alpha source limbs) and
every target prime p:

    y[j, ..., p, :] = sum_{t in group j} (x[t] * fold[t] mod q_t)
                      * conv[t, p]  mod p

The decomposition (Q_l -> Q_l u P) and the mod-down conversion (P -> Q_l,
`prefolded=True`, nd = 1) of every key switch run through here.  Tables
are a `ckks.context.BCTables`.  Source rows past x.shape[-2] (a partly
filled last digit group) count as zero, so callers pass only the active
limbs.  A CUDA tensor goes to `csrc/basecvt.cu`; a CPU tensor to the plain
int64 version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import KERNEL_LAUNCHES
from . import cuda_build
from .modarith import shoup_mulmod

MAX_ALPHA = 32          # the kernel keeps one digit's folded sources in registers

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


def _lib():
    lib = cuda_build.library("basecvt")
    if not getattr(lib, "_typed", False):
        lib.base_convert.restype = _I
        lib.base_convert.argtypes = [_P] * 8 + [_I] * 7 + [_P]
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
        raise ValueError(f"alpha {bc.alpha} exceeds the kernel's {MAX_ALPHA}")
    if x.device != bc.conv.device:
        raise ValueError(f"tensor on {x.device}, tables on {bc.conv.device}")
    lead = x.shape[:-2]
    batch = x.numel() // (g_valid * n) if x.numel() else 0
    if batch >= 65536:
        raise ValueError(f"batch {batch} exceeds the grid's y dimension")
    tgt = bc.q_out.shape[0]
    out = torch.empty((bc.nd,) + lead + (tgt, n), dtype=torch.int32,
                      device=x.device)
    if batch == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().base_convert(
            x.data_ptr(), out.data_ptr(), bc.fold.data_ptr(),
            bc.fold_s.data_ptr(), bc.gq.data_ptr(), bc.conv.data_ptr(),
            bc.q_out.data_ptr(), bc.q_inv.data_ptr(), batch, g_valid, bc.nd,
            bc.alpha, tgt, n, int(prefolded),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"base_convert launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["base_convert"] += 1
    return out
