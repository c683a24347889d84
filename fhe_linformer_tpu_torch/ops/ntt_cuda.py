"""Wrappers of the CUDA NTT kernels K1 (forward) and K2 (inverse).

`csrc/ntt.cu` runs one thread block per residue row with the whole row in
shared memory; these wrappers check the tensors, launch on PyTorch's
current stream and count the launches.  The plain versions they replace on
the CPU are `ntt.fwd_plain` / `ntt.inv_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import KERNEL_LAUNCHES
from . import cuda_build
from .ntt import NttTables

# A row lives in one block's shared memory: 2**15 u32 = 128 KB of the
# 227 KB a block may use.  Ring 2**16 rows (256 KB) do not fit.
MAX_LOGN = 15

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = cuda_build.library("ntt")
    if not getattr(lib, "_typed", False):
        for fn in (lib.ntt_forward, lib.ntt_inverse):
            fn.restype = _I
        lib.ntt_forward.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P]
        lib.ntt_inverse.argtypes = [_P, _P, _P, _I, _I, _P, _P, _P, _P,
                                    _P, _P]
        lib._typed = True
    return lib


def _check(x: torch.Tensor, t: NttTables, limbs) -> int:
    if not x.is_cuda:
        raise ValueError("the CUDA NTT takes a CUDA tensor")
    if x.dtype != torch.int32:
        raise TypeError(f"residues must be int32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("residues must be contiguous")
    if x.dim() < 2 or x.shape[-1] != t.n or x.shape[-2] != len(limbs):
        raise ValueError(f"shape {tuple(x.shape)} does not match n={t.n}, "
                         f"{len(limbs)} limbs")
    if t.logn > MAX_LOGN:
        raise ValueError(f"ring 2^{t.logn} rows do not fit one thread "
                         f"block's shared memory (max 2^{MAX_LOGN})")
    if x.device != t.device:
        raise ValueError(f"tensor on {x.device}, tables on {t.device}")
    return x.numel() // t.n


def _row_limbs(t: NttTables, limbs, rows: int) -> torch.Tensor:
    return t.index(limbs).int().repeat(rows // len(limbs))


def fwd(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    rows = _check(x, t, limbs)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rl = _row_limbs(t, limbs, rows)
    with torch.cuda.device(x.device):
        rc = _lib().ntt_forward(
            x.data_ptr(), out.data_ptr(), rl.data_ptr(), rows, t.logn,
            t.q.data_ptr(), t.psi_rev.data_ptr(), t.psi_rev_s.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ntt_forward launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["ntt_fwd"] += 1
    return out


def inv(x: torch.Tensor, t: NttTables, limbs) -> torch.Tensor:
    rows = _check(x, t, limbs)
    out = torch.empty_like(x)
    if rows == 0:
        return out
    rl = _row_limbs(t, limbs, rows)
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
