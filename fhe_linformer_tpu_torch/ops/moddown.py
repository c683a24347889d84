"""The key switch's mod-down: the CUDA kernel K5's wrapper and its plain
PyTorch version.

    mod_down(x) = round(x / P) over Q_l:  x (..., nl + k, N) over Q_l * P
                  -> (..., nl, N), plus an optional addend per key half

for canonical int32 residues, `ks` a level's key-switch tables
(`ckks.context.LevelKS`).  Both routes run K2 on x's special rows (read
in place), fold them by (P/p_t)^-1 and take the conversion's overflow v
(`md_fold`), convert P -> Q_l on K3 (prefolded), subtract v [P]_{q_i}
(`md_lift`), run K1, and finish with (x_Q - y_e) P^-1 mod q_i, adding the
caller's term for each key half (`md_finish`: the Galois switch's
permuted c0, the combo's a0 sums, the product's d0 and d1).  The key
halves lie on axis `half_dim` of x; the addend of half h has x's leading
shape without that axis.

K5 (`csrc/moddown.cu`, three entry points) replaces no Pallas kernel: the
JAX package left these passes to XLA.  A CUDA tensor goes to its entry
points, a CPU tensor to the plain int64 versions, the evaluator's former
expressions; both return canonical residues, so they agree bit for bit.
`GLOBAL_TIMERS.counts["mod_down"]` counts the mod-downs on either route,
`KERNEL_LAUNCHES` each entry point's launches: in one process on the
card `counts["mod_down"]` equals the launches of `md_finish`.  The
limb-sharded mod-down (`parallel/ksprod.py`) runs `md_lift` and `md_finish`
(or their plain versions) over each rank's rows, its `RankKS` standing in
for the level's tables; its fold stays apart, since it all-reduces the
`md_partials` of the rank's special rows before `md_round`.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.timing import GLOBAL_TIMERS, KERNEL_LAUNCHES
from . import cuda_build, ntt
from .basecvt import base_convert
from .modarith import addmod_plain, mulmod_plain, submod_plain
from .ntt_cuda import entry_stride

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def mod_down(x: torch.Tensor, t: ntt.NttTables, ks, add=None,
             half_dim: int = 0, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """x: (..., nl + k, N) int32 with its two key halves on `half_dim`;
    add: None or (add0, add1), each None or x's leading shape without
    `half_dim` + (nl, N).  Returns (..., nl, N) int32, written into `out`
    when given."""
    GLOBAL_TIMERS.count("mod_down")
    if x.is_cuda:
        return mod_down_cuda(x, t, ks, add, half_dim, out)
    return mod_down_plain(x, t, ks, add, half_dim, out)


# ---------------------------------------------------------------------------
# the plain route


def md_partials(w, mdq40):
    """The exact integer partial sums (al, ahbb) of `md_overflow` over the
    rows of w; sums over disjoint row sets add (the limb-sharded mod-down
    all-reduces them before `md_round`)."""
    w = w.long()
    a = (w & 0xFFFF) * mdq40
    b = (w >> 16) * mdq40
    return ((a & 0xFFFF).sum(-2, keepdim=True),
            ((a >> 16) + b).sum(-2, keepdim=True))


def md_round(al, ahbb):
    """The single float32 combine of the partial sums, rounded half to
    even."""
    s = al.float() * (2.0 ** -40) + ahbb.float() * (2.0 ** -24)
    return torch.round(s).int()


def md_overflow(w, mdq40):
    """round(sum_t w_t / p_t), the CRT overflow of the fast base conversion
    P -> Q, in the JAX package's exact fixed point: integer 16-bit partial
    sums, combined in float32 at the end and rounded half to even."""
    return md_round(*md_partials(w, mdq40))


def md_fold_plain(vp, ks):
    """(w, v): the special rows vp (..., k, N) folded by (P/p_t)^-1, and
    their overflow (..., 1, N)."""
    w = mulmod_plain(vp, ks.pfold, ks.q_sp)
    return w, md_overflow(w, ks.mdq40)


def md_lift_plain(y, v, ks):
    """y - v [P]_{q_i} mod q_i over the nl active rows of y."""
    return submod_plain(y, mulmod_plain(v, ks.pmod, ks.q_act), ks.q_act)


def md_finish_plain(x, y_e, ks, add=None, half_dim=0, out=None):
    """(x_Q - y_e) [P^-1]_{q_i} mod q_i, each half's addend added."""
    nl = ks.nl
    res = mulmod_plain(submod_plain(x[..., :nl, :], y_e, ks.q_act), ks.pinv,
                       ks.q_act)
    for h, a in enumerate(add or ()):
        if a is not None:
            r = res.select(half_dim, h)
            r.copy_(addmod_plain(a, r, ks.q_act))
    if out is None:
        return res
    out.copy_(res)
    return out


def mod_down_plain(x, t, ks, add=None, half_dim=0, out=None):
    nl = ks.nl
    vp = ntt.inv(x[..., nl:, :], t, ks.sp_idx)
    w, v = md_fold_plain(vp, ks)
    y = md_lift_plain(base_convert(w, ks.md, prefolded=True)[0], v, ks)
    y_e = ntt.fwd(y, t, ks.act_idx)
    return md_finish_plain(x, y_e, ks, add, half_dim, out)


# ---------------------------------------------------------------------------
# the card


def _lib():
    lib = cuda_build.library("moddown")
    if not getattr(lib, "_typed", False):
        for fn in (lib.md_fold, lib.md_lift, lib.md_finish):
            fn.restype = _I
        lib.md_fold.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.md_lift.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.md_finish.argtypes = [_P, _LL, _P, _P, _LL, _P, _P, _LL, _LL,
                                  _LL, _P, _P, _P, _I, _I, _I, _P]
        lib._typed = True
    return lib


def _span(x: torch.Tensor) -> tuple[int, int]:
    """The byte range [lo, hi) of x's elements in its storage."""
    lo = x.data_ptr()
    last = sum((s - 1) * st for s, st in zip(x.shape, x.stride()))
    return lo, lo + (last + 1) * x.element_size()


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.numel() == 0 or b.numel() == 0:
        return False
    (a0, a1), (b0, b1) = _span(a), _span(b)
    return a0 < b1 and b0 < a1


def _residues(name: str, x: torch.Tensor, rows: int, n: int, device) -> int:
    """Checks x: int32 on `device`, (..., rows, n), rows n apart, entries
    at one stride, 16-byte aligned; returns that entry stride."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, x on {device}")
    if x.dim() < 2 or x.shape[-2] != rows or x.shape[-1] != n:
        raise ValueError(f"{name} must be (..., {rows}, {n}), got "
                         f"{tuple(x.shape)}")
    try:
        stride = entry_stride(x)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if stride % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (entry stride "
                         f"{stride})")
    return stride


def finish_args(x, ks, add=None, half_dim=0, out=None) -> tuple:
    """K5's arguments for the whole mod-down of x after every check of what
    the kernels take (dtypes, row counts, strides, the halves' axis, the
    addends' shapes, an `out` that overlaps no input), with `out`
    allocated when not given: (x_es, out, out_es, adds, add_es, inner,
    batch)."""
    nl, k = ks.nl, ks.q_sp.shape[0]
    if x.dim() < 3:
        raise ValueError(f"x must be (..., nl + k, N), got {tuple(x.shape)}")
    n = x.shape[-1]
    if n % 4:
        raise ValueError(f"n = {n} is not a multiple of 4")
    x_es = _residues("x", x, nl + k, n, x.device)
    lead = tuple(x.shape[:-2])
    if not 0 <= half_dim < len(lead) or lead[half_dim] != 2:
        raise ValueError(f"axis {half_dim} of x {tuple(x.shape)} must hold "
                         "the two key halves")
    inner = int(torch.Size(lead[half_dim + 1:]).numel())
    batch = int(torch.Size(lead).numel())
    want = lead[:half_dim] + lead[half_dim + 1:] + (nl, n)
    adds, add_es = [None, None], [0, 0]
    for h, a in enumerate(add or ()):
        if h > 1:
            raise ValueError("add takes one addend per key half")
        if a is None:
            continue
        add_es[h] = _residues(f"add{h}", a, nl, n, x.device)
        if tuple(a.shape) != want:
            raise ValueError(f"add{h} must be {want}, got {tuple(a.shape)}")
        adds[h] = a
    if out is None:
        out = torch.empty(lead + (nl, n), dtype=torch.int32, device=x.device)
    elif tuple(out.shape) != lead + (nl, n):
        raise ValueError(f"out must be {lead + (nl, n)}, got "
                         f"{tuple(out.shape)}")
    out_es = _residues("out", out, nl, n, x.device)
    for name, other in (("x", x), ("add0", adds[0]), ("add1", adds[1])):
        if other is not None and _overlap(out, other):
            raise ValueError(f"out overlaps {name}")
    return x_es, out, out_es, adds, add_es, inner, batch


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES[name] += 1


def md_fold(vp, ks):
    """K5's md_fold on K2's output vp (..., k, N), contiguous."""
    k, n = ks.q_sp.shape[0], vp.shape[-1]
    _residues("vp", vp, k, n, vp.device)
    if not vp.is_contiguous():
        raise ValueError("vp must be contiguous")
    w = torch.empty_like(vp)
    v = torch.empty(vp.shape[:-2] + (1, n), dtype=torch.int32,
                    device=vp.device)
    batch = vp.numel() // (k * n)
    if batch:
        with torch.cuda.device(vp.device):
            rc = _lib().md_fold(
                vp.data_ptr(), w.data_ptr(), v.data_ptr(),
                ks.q_sp.data_ptr(), ks.pfold.data_ptr(),
                ks.pfold_s.data_ptr(), ks.mdq40.data_ptr(), batch, k, n,
                _stream(vp))
        _raise("md_fold", rc)
    return w, v


def md_lift(y, v, ks):
    """K5's md_lift on K3's output y (..., nl, N), in place."""
    nl, n = ks.nl, y.shape[-1]
    _residues("y", y, nl, n, y.device)
    _residues("v", v, 1, n, y.device)
    if not (y.is_contiguous() and v.is_contiguous()) \
            or v.shape[:-2] != y.shape[:-2]:
        raise ValueError(f"y {tuple(y.shape)} and v {tuple(v.shape)} must "
                         "be contiguous, with one leading shape")
    batch = y.numel() // (nl * n)
    if batch:
        with torch.cuda.device(y.device):
            rc = _lib().md_lift(
                y.data_ptr(), v.data_ptr(), ks.q_act.data_ptr(),
                ks.pmod.data_ptr(), ks.pmod_s.data_ptr(), batch, nl, n,
                _stream(y))
        _raise("md_lift", rc)
    return y


def md_finish(x, y_e, ks, add=None, half_dim=0, out=None):
    """K5's md_finish: x's Q rows read in place, y_e (..., nl, N)
    contiguous from K1."""
    return _finish(x, y_e, ks, finish_args(x, ks, add, half_dim, out))


def _finish(x, y_e, ks, args):
    """md_finish with finish_args' result `args`."""
    x_es, out, out_es, adds, add_es, inner, batch = args
    nl, n = ks.nl, x.shape[-1]
    _residues("y_e", y_e, nl, n, x.device)
    if not y_e.is_contiguous() or y_e.shape[:-2] != x.shape[:-2]:
        raise ValueError(f"y_e {tuple(y_e.shape)} must be contiguous, with "
                         "x's leading shape")
    if batch:
        ptr = lambda a: None if a is None else a.data_ptr()
        with torch.cuda.device(x.device):
            rc = _lib().md_finish(
                x.data_ptr(), x_es, y_e.data_ptr(), out.data_ptr(), out_es,
                ptr(adds[0]), ptr(adds[1]), add_es[0], add_es[1], inner,
                ks.q_act.data_ptr(), ks.pinv.data_ptr(), ks.pinv_s.data_ptr(),
                batch, nl, n, _stream(x))
        _raise("md_finish", rc)
    return out


def mod_down_cuda(x, t, ks, add=None, half_dim=0, out=None):
    if not x.is_cuda:
        raise ValueError("K5 takes CUDA tensors")
    args = finish_args(x, ks, add, half_dim, out)   # refuse before K2 runs
    nl = ks.nl
    w, v = md_fold(ntt.inv(x[..., nl:, :], t, ks.sp_idx), ks)
    y = md_lift(base_convert(w, ks.md, prefolded=True)[0], v, ks)
    return _finish(x, ntt.fwd(y, t, ks.act_idx), ks, args)
