"""The key switch's modular multiply-accumulate: the CUDA kernel K4's
wrapper and its plain PyTorch version.

    out[h, ..., r, c] = sum_j a[sel_j, ..., r, perm(c)] * w_h[j, row(r), c]
                        mod q_r,    row(r) = r if r < split else r + w_off

for canonical int32 residues: the key-digit inner products of every key
switch (w = the key's (b, a) halves, j over the digits, row() reading the
active rows and the specials block in place, perm the Galois gather of a
hoisted rotation) and the rotation combo's plaintext sums (w = the
plaintexts' rows, j over a giant group's babies, picked by sel).  The
weights broadcast over a's leading axes.

K4 (`csrc/ksmac.cu`) replaces no Pallas kernel: the JAX package left these
sums to XLA.  A CUDA tensor goes to it and a CPU tensor to the plain int64
version, the evaluator's former expressions; both return canonical
residues, so they agree bit for bit.  `GLOBAL_TIMERS.counts["ks_mac"]`
counts the calls on either route, `KERNEL_LAUNCHES["ks_mac"]` the kernel's
launches: on the card the two are equal.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import GLOBAL_TIMERS, KERNEL_LAUNCHES
from . import cuda_build

MAX_J = 64              # digits or baby rows a launch (csrc/ksmac.cu kMaxJ)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def ks_mac(a: torch.Tensor, w, q: torch.Tensor, split: int | None = None,
           w_off: int = 0, sel=None, perm: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """a: (J_a, ..., R, N) int32; w: 1 or 2 weight tensors (J_w, R_w, N);
    q: (R, 1) moduli; sel: J indices into a's first axis (None: all of
    it); perm: (N,) gather index; split: None for R.  Returns
    (len(w), ..., R, N) int32, written into `out` when given."""
    GLOBAL_TIMERS.count("ks_mac")
    if a.is_cuda:
        return ks_mac_cuda(a, w, q, split, w_off, sel, perm, out)
    return ks_mac_plain(a, w, q, split, w_off, sel, perm, out)


def ks_mac_plain(a, w, q, split=None, w_off=0, sel=None, perm=None,
                 out=None) -> torch.Tensor:
    if perm is not None:
        a = a.index_select(-1, perm)
    if sel is not None:
        a = a.index_select(0, torch.as_tensor(sel, device=a.device))
    J, R = a.shape[0], a.shape[-2]
    split = R if split is None else split
    bshape = (J,) + (1,) * (a.dim() - 3)
    halves = []
    for half in w:
        parts = []
        for y, k, qr in ((a[..., :split, :], half[:J, :split], q[:split]),
                         (a[..., split:, :],
                          half[:J, split + w_off:R + w_off], q[split:])):
            if y.shape[-2] == 0:
                continue
            k = k.reshape(bshape + k.shape[1:])
            prod = torch.remainder(y.long() * k, qr)
            parts.append(torch.remainder(prod.sum(0), qr).int())
        halves.append(torch.cat(parts, -2))
    res = torch.stack(halves)
    if out is None:
        return res
    out.copy_(res)
    return out


def _lib():
    lib = cuda_build.library("ksmac")
    if not getattr(lib, "_typed", False):
        lib.ks_mac.restype = _I
        lib.ks_mac.argtypes = [_P, _LL, _P, _P, _LL, _P, _P, _P, _LL, _P] + \
            [_I] * 7 + [_P]
        lib._typed = True
    return lib


def _stride0(x: torch.Tensor, what: str) -> int:
    """The element stride between x's entries x[i], each of which must be
    contiguous (0 for a single entry)."""
    if not x[0].is_contiguous():
        raise ValueError(f"{what}'s entries must be contiguous")
    s = x.stride(0) if x.shape[0] > 1 else 0
    if s % 4 or x.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned (stride {s})")
    return s


def launch_args(a, w, q, split=None, w_off=0, sel=None, perm=None,
                out=None) -> tuple:
    """K4's arguments after every check of what the kernel takes (dtypes,
    shapes, one device, contiguous rows, 16-byte alignment), with `out`
    allocated when not given: (a_js, w, w_js, out, out_hs, J, batch, R, n,
    split)."""
    w = tuple(w)
    H = len(w)
    if H not in (1, 2):
        raise ValueError(f"K4 takes 1 or 2 weight tensors, got {H}")
    if a.dim() < 3:
        raise ValueError(f"a must be (J, ..., R, N), got {tuple(a.shape)}")
    R, n = a.shape[-2], a.shape[-1]
    lead = tuple(a.shape[1:-2])
    J = a.shape[0] if sel is None else len(sel)
    split = R if split is None else split
    if sel is not None and not all(0 <= int(s) < a.shape[0] for s in sel):
        raise ValueError(f"sel {list(sel)} outside a's {a.shape[0]} entries")
    if not 1 <= J <= MAX_J:
        raise ValueError(f"{J} digits or rows: the kernel takes 1..{MAX_J}")
    if not 0 <= split <= R or n % 4:
        raise ValueError(f"split {split} outside 0..{R}, or n = {n} not a "
                         "multiple of 4")
    named = [("a", a), ("q", q), *((f"w{h}", x) for h, x in enumerate(w))]
    if perm is not None:
        named.append(("perm", perm))
    if out is not None:
        named.append(("out", out))
    for name, x in named:
        want = torch.int64 if name == "perm" else torch.int32
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, a on {a.device}")
    # weight rows read: [0, split) and [split + w_off, R + w_off)
    lo = split + w_off if split < R else 0
    top = max(split, R + w_off if split < R else 0) - 1
    for h, x in enumerate(w):
        if x.dim() != 3 or x.shape[-1] != n or x.shape[0] < J or lo < 0 \
                or top >= x.shape[1]:
            raise ValueError(f"w{h} {tuple(x.shape)} cannot serve {J} "
                             f"digits of rows 0..{split - 1} and "
                             f"{lo}..{top}, n = {n}")
    w_js = [_stride0(x, f"w{h}") for h, x in enumerate(w)]
    if H == 2 and w[0].shape[0] > 1 and w_js[0] != w_js[1]:
        raise ValueError("the two weight tensors need one digit stride")
    if tuple(q.shape) not in ((R, 1), (R,)) or not q.is_contiguous():
        raise ValueError(f"q must be ({R}, 1) contiguous, got "
                         f"{tuple(q.shape)}")
    a_js = _stride0(a, "a")
    if perm is not None and (tuple(perm.shape) != (n,)
                             or not perm.is_contiguous()):
        raise ValueError(f"perm must be ({n},) contiguous")
    if out is None:
        out = torch.empty((H,) + lead + (R, n), dtype=torch.int32,
                          device=a.device)
    elif tuple(out.shape) != (H,) + lead + (R, n):
        raise ValueError(f"out must be {(H,) + lead + (R, n)}, got "
                         f"{tuple(out.shape)}")
    return (a_js, w, w_js[0], out, _stride0(out, "out"), J,
            a[0].numel() // (R * n), R, n, split)


def ks_mac_cuda(a, w, q, split=None, w_off=0, sel=None, perm=None,
                out=None) -> torch.Tensor:
    if not a.is_cuda:
        raise ValueError("K4 takes CUDA tensors")
    a_js, w, w_js, out, out_hs, J, batch, R, n, split = launch_args(
        a, w, q, split, w_off, sel, perm, out)
    if batch == 0:
        return out
    csel = None if sel is None else (ctypes.c_int * J)(*map(int, sel))
    with torch.cuda.device(a.device):
        rc = _lib().ks_mac(
            a.data_ptr(), a_js, w[0].data_ptr(), w[-1].data_ptr(), w_js,
            q.data_ptr(), None if perm is None else perm.data_ptr(),
            out.data_ptr(), out_hs, csel, J, len(w), batch, R, n, split,
            w_off, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ks_mac launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES["ks_mac"] += 1
    return out
