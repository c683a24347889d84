"""The evaluator's residue arithmetic: the CUDA kernel K6's wrapper and its
plain PyTorch version.

    mod_ew(op, a, b, q, c, d):  a*b, a+b, a-b, -a, a*b + c or a*b + c*d
                                mod q, elementwise ("mul", "add", "sub",
                                "neg", "fma", "dot")
    rescale(c0, c1, t, plan, f, add, mode):
                                (c0 f, c1 f) with limb nl - 1 dropped by the
                                centred lift, each half's addend added (or
                                the result subtracted from it): K2 on the
                                top limb (of x*f, a one-limb `mod_ew`
                                product, when a factor is given),
                                `rs_lift`, K1 and `rs_finish`

for canonical int32 residues (..., L, N) and (L, 1) int32 moduli.  The
operands of `mod_ew` and `rs_finish` broadcast against each other (a
plaintext's rows over a batch, an (L, 1) or (1, 1) constant) and are read
in place as the views they are (a limb slice, one ciphertext of a batch);
`out` takes a view to write, which may be one of the inputs itself.

K6 (`csrc/modops.cu`, three entry points) replaces no Pallas kernel: the
JAX package left these passes to XLA.  A CUDA tensor goes to its entry
points, a CPU tensor to the plain versions, the evaluator's former int64
expressions (`ops/modarith.py`); both return canonical residues, so they
agree bit for bit.  `GLOBAL_TIMERS.counts["mod_ew"]`, `["rs_lift"]` and
`["rs_finish"]` count the calls on either route, `KERNEL_LAUNCHES` each
entry point's launches: in one process on the card each count equals its
launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import struct

import torch

from ..utils.timing import GLOBAL_TIMERS, KERNEL_LAUNCHES
from . import cuda_build, ntt
from .modarith import addmod_plain, mulmod_plain, negmod_plain, submod_plain

_DIMS = 4                   # leading axes the kernels index (kDims)
# op -> (the kernel's code, operands taken)
OPS = {"mul": (0, 2), "add": (1, 2), "sub": (2, 2), "neg": (3, 1),
       "fma": (4, 3), "dot": (5, 4)}
# rs_finish's mode -> the kernel's code: r + a, a - r
MODES = {"add": 0, "rsub": 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def mod_ew(op: str, a: torch.Tensor, b: torch.Tensor | None,
           q: torch.Tensor, c: torch.Tensor | None = None,
           d: torch.Tensor | None = None,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """The elementwise `op` of a, b (None for "neg"), c and d mod q: (the
    operands' broadcast shape) int32, written into `out` when given."""
    GLOBAL_TIMERS.count("mod_ew")
    if a.is_cuda:
        return _launch_ew(ew_args(op, a, b, q, c, d, out))
    return mod_ew_plain(op, a, b, q, c, d, out)


def rs_lift(v: torch.Tensor, plan) -> torch.Tensor:
    """The rescale's centred lift of the dropped limb's coefficients v (...,
    1, N) onto the nl - 1 remaining limbs: (..., nl - 1, N)."""
    GLOBAL_TIMERS.count("rs_lift")
    if v.is_cuda:
        return _rs_lift_cuda(v, plan)
    return rs_lift_plain(v, plan)


def rs_finish(x0, x1, lift_e, plan, f=None, add=None,
              mode: str = "add") -> torch.Tensor:
    """r_h = (x_h f - lift_e[h]) qd^-1 mod q_i over x_h's first nl - 1
    limbs, for the halves h = 0, 1, then with add[h]: r_h + add[h] (mode
    "add") or add[h] - r_h ("rsub"); (2, ..., nl - 1, N), lift_e's
    shape.  f: None or residues over nl limbs (or one)
    broadcast against x; add: None or (add0, add1), each None or residues
    over nl - 1 limbs (or one)."""
    GLOBAL_TIMERS.count("rs_finish")
    if lift_e.is_cuda:
        return _launch_finish(finish_args(x0, x1, lift_e, plan, f, add,
                                          mode))
    return rs_finish_plain(x0, x1, lift_e, plan, f, add, mode)


def rescale(c0, c1, t: ntt.NttTables, plan, f=None, add=None,
            mode: str = "add") -> torch.Tensor:
    """(c0 f, c1 f) with limb nl - 1 dropped: (2, ..., nl - 1, N), the
    halves' addends taken in by `mode` (rs_finish's) in the last pass."""
    nl = plan.nl
    v = ntt.inv(_top(c0, c1, plan, f), t, (nl - 1,))
    lift_e = ntt.fwd(rs_lift(v, plan), t, tuple(range(nl - 1)))
    return rs_finish(c0, c1, lift_e, plan, f, add, mode)


def _pair(c0, c1):
    """(c0, c1) as one (2, ...) view when c1 directly follows c0 in one
    storage, both contiguous (the halves of one rescale or mod-down);
    else None."""
    if c0.shape != c1.shape or c0.numel() == 0 \
            or not (c0.is_contiguous() and c1.is_contiguous()) \
            or c1.data_ptr() != c0.data_ptr() + 4 * c0.numel() \
            or c0.untyped_storage().data_ptr() != \
            c1.untyped_storage().data_ptr():
        return None
    return c0.as_strided((2,) + tuple(c0.shape), (c0.numel(),) + c0.stride(),
                         c0.storage_offset())


def _top(c0, c1, plan, f):
    """The top limb of both halves, (2, ..., 1, N): read in place from a
    pair, else stacked; times f's top row when f is given."""
    t = plan.nl - 1
    pair = _pair(c0, c1)
    if f is None:
        if pair is not None:
            return pair[..., t:, :]
        return torch.stack((c0[..., t:, :], c1[..., t:, :]))
    ft = f[..., t:, :] if f.shape[-2] > 1 else f
    if pair is not None:
        return mod_ew("mul", pair[..., t:, :], ft, plan.qd)
    lead = broadcast_shape([c0.shape[:-2], c1.shape[:-2], ft.shape[:-2]])
    top = c0.new_empty((2,) + lead + (1, c0.shape[-1]))
    for h, c in enumerate((c0, c1)):
        mod_ew("mul", c[..., t:, :], ft, plan.qd, out=top[h])
    return top


# ---------------------------------------------------------------------------
# the plain route


def mod_ew_plain(op, a, b, q, c=None, d=None, out=None):
    if op == "mul":
        res = mulmod_plain(a, b, q)
    elif op == "add":
        res = addmod_plain(a, b, q)
    elif op == "sub":
        res = submod_plain(a, b, q)
    elif op == "neg":
        res = negmod_plain(a, q)
    elif op == "fma":
        res = addmod_plain(mulmod_plain(a, b, q), c, q)
    elif op == "dot":
        res = addmod_plain(mulmod_plain(a, b, q), mulmod_plain(c, d, q), q)
    else:
        raise ValueError(f"unknown op {op!r}: one of {sorted(OPS)}")
    if out is None:
        return res
    out.copy_(res)
    return out


def rs_lift_plain(v, plan):
    vm = torch.remainder(v, plan.qrem)
    return torch.where(v <= plan.half, vm, submod_plain(vm, plan.qdm,
                                                        plan.qrem))


def rs_finish_plain(x0, x1, lift_e, plan, f=None, add=None, mode="add"):
    m, q = plan.nl - 1, plan.qrem
    xs = [x[..., :m, :] for x in (x0, x1)]
    if f is not None:
        fm = f[..., :m, :] if f.shape[-2] > 1 else f
        xs = [mulmod_plain(x, fm, q) for x in xs]
    lead = tuple(lift_e.shape[1:-2])
    x = torch.stack([x.expand(lead + x.shape[-2:]) for x in xs])
    out = mulmod_plain(submod_plain(x, lift_e, q), plan.inv, q)
    step = {"add": addmod_plain,
            "rsub": lambda r, a, q: submod_plain(a, r, q)}[mode]
    for h, a in enumerate(add or ()):
        if a is not None:
            out[h] = step(out[h], a, q)
    return out


# ---------------------------------------------------------------------------
# the card

# A call's layout (the op, and each operand's shape, strides, dtype and
# device) -> what the checks derive from it: the evaluator repeats a few
# hundred layouts, so each is checked once and a call only fills in its
# pointers and checks their alignment and overlaps.  Dropped whole when
# full.
_LAYOUTS: dict = {}
_MAX_LAYOUTS = 4096


class _Layout:
    """A checked layout: the output's shape, the descriptor's words with
    the pointers left 0, and per pointer (operand index, word index, 16-byte
    alignment needed); for an `out` given, each input's extent in bytes and
    whether it has out's strides (in place when it starts where out
    does)."""

    def __init__(self, shape, words, batch, ptrs, names, spans=None):
        self.shape, self.words, self.batch = shape, words, batch
        self.ptrs, self.names, self.spans = ptrs, names, spans


def _key(*xs) -> tuple:
    return tuple(None if x is None else
                 (x.shape, x.stride(), x.dtype, x.device) for x in xs)


def _remember(key, lay: _Layout) -> _Layout:
    if len(_LAYOUTS) >= _MAX_LAYOUTS:
        _LAYOUTS.clear()
    _LAYOUTS[key] = lay
    return lay


def _lib():
    lib = cuda_build.library("modops")
    if not getattr(lib, "_typed", False):
        for fn in (lib.mod_ew, lib.rs_lift, lib.rs_finish):
            fn.restype = _I
        lib.mod_ew.argtypes = [ctypes.c_char_p, _P]
        lib.rs_finish.argtypes = [ctypes.c_char_p, _P]
        lib.rs_lift.argtypes = [_P] * 5 + [_LL, _I, _I, _I, _P]
        lib._typed = True
    return lib


def _residues(name: str, x, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, a on {device}")
    if x.dim() < 2:
        raise ValueError(f"{name} must be (..., L, N), got "
                         f"{tuple(x.shape)}")


def _moduli(name: str, q, rows: int, device) -> None:
    _residues(name, q, device)
    if tuple(q.shape) != (rows, 1) or not q.is_contiguous():
        raise ValueError(f"{name} must be contiguous ({rows}, 1), got "
                         f"{tuple(q.shape)}")


def broadcast_shape(shapes) -> tuple:
    """The shapes' broadcast shape, in plain Python: the first
    torch.broadcast_shapes call of a process imports sympy (seconds)."""
    nd = max(len(sh) for sh in shapes)
    out = [1] * nd
    for sh in shapes:
        for i, s in enumerate(sh, nd - len(sh)):
            if s != 1 and out[i] not in (1, s):
                raise ValueError(f"operands do not broadcast: "
                                 f"{[tuple(x) for x in shapes]}")
            if s != 1:
                out[i] = s
    return tuple(out)


def _strides(x, shape) -> list:
    """x's strides against `shape`: 0 on an axis x lacks or holds once."""
    pad = len(shape) - x.dim()
    return [0] * pad + [0 if s == 1 else st
                        for s, st in zip(x.shape, x.stride())]


def _extent(strides, shape) -> int:
    """The bytes from an operand's first element to past its last, read at
    `strides`."""
    return 4 * (sum((s - 1) * st for s, st in zip(shape, strides)) + 1)


def _words(name, x, strides, lead_strides) -> list:
    """An operand's descriptor words: pointer (0 here, filled per call),
    row stride, column stride, the merged leading strides (innermost
    first, padded with 0), after the checks of what the kernels take."""
    rs, cs = strides[-2], strides[-1]
    if cs not in (0, 1):
        raise ValueError(f"{name}: coefficients must be contiguous or "
                         f"broadcast, got strides {x.stride()}")
    if cs and (rs % 4 or any(st % 4 for st in lead_strides)):
        raise ValueError(f"{name} must be 16-byte aligned with strides that "
                         f"are multiples of 4, got strides {x.stride()}")
    return [0, rs, cs] + lead_strides + [0] * (_DIMS - len(lead_strides))


def _describe(shape, named) -> list:
    """The leading axes of `shape` (..., L, N), merged where the strides of
    every operand in `named` [(name, tensor or None)] allow, and each
    operand's words (zeros for an absent one): [nd, sizes..., words...]."""
    nlead = len(shape) - 2
    full = [None if x is None else _strides(x, shape) for _, x in named]
    sizes: list[int] = []
    lead: list[list[int]] = [[] for _ in named]
    for ax in range(nlead - 1, -1, -1):               # innermost first
        s = shape[ax]
        if s == 1:
            continue
        if sizes and all(st is None or st[ax] == ld[-1] * sizes[-1]
                         for st, ld in zip(full, lead)):
            sizes[-1] *= s                            # folds into the inner
            continue
        sizes.append(s)
        for st, ld in zip(full, lead):
            if st is not None:
                ld.append(st[ax])
    if len(sizes) > _DIMS:
        raise ValueError(f"the operands' leading axes {shape[:-2]} merge to "
                         f"{len(sizes)}, more than {_DIMS}")
    nd = max(len(sizes), 1)
    words = [nd] + sizes + [1] * (_DIMS - len(sizes))
    for (name, x), st, ld in zip(named, full, lead):
        words += [0] * (3 + _DIMS) if x is None else \
            _words(name, x, st, ld)
    return words


def _pointers(named, first: int) -> list:
    """(operand index, word index, 16-byte alignment needed) of each
    operand present in `named`, whose words start at `first`."""
    return [(i, first + (3 + _DIMS) * i, x.shape[-1] != 1)
            for i, (_, x) in enumerate(named)
            if x is not None and x.numel()]


def _fill(lay: _Layout, xs) -> list:
    """The layout's words with the pointers of xs (its operands, in order)
    filled in, each checked for alignment."""
    words = list(lay.words)
    for i, at, vec in lay.ptrs:
        p = xs[i].data_ptr()
        if vec and p % 16:
            raise ValueError(f"{lay.names[i]} must be 16-byte aligned with "
                             f"strides that are multiples of 4, got "
                             f"address {p:#x}")
        words[at] = p
    return words


def _overlaps(lay: _Layout, out, ins) -> None:
    """Refuses an `out` that shares elements with an input it is not."""
    o0 = out.data_ptr()
    o1 = o0 + lay.spans[0][0]
    for i, (x, (ext, same)) in enumerate(zip(ins, lay.spans[1:])):
        if ext is None:
            continue
        x0 = x.data_ptr()
        if same and x0 == o0:
            continue                          # in place: each thread alone
        if x0 < o1 and o0 < x0 + ext:
            raise ValueError(f"out overlaps {lay.names[i + 1]}")


def _ew_layout(op, a, b, q, c, d, out) -> _Layout:
    """mod_ew's checks of what the kernel takes (op, dtypes, devices, the
    moduli's shape, broadcasting, layouts) and its descriptor, pointers
    left out."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}: one of {sorted(OPS)}")
    code, k = OPS[op]
    named = list(zip("abcd", (a, b, c, d)))
    for i, (name, x) in enumerate(named):
        if (x is None) == (i < k):
            raise ValueError(f"{op} takes {k} operands: {name} is "
                             f"{'missing' if x is None else 'extra'}")
    _residues("a", a, a.device)
    for name, x in named[1:k]:
        _residues(name, x, a.device)
    shape = broadcast_shape([x.shape for _, x in named[:k]])
    rows, n = shape[-2], shape[-1]
    _moduli("q", q, rows, a.device)
    if n % 4:
        raise ValueError(f"n = {n} is not a multiple of 4")
    spans = None
    if out is not None:
        _residues("out", out, a.device)
        if tuple(out.shape) != shape:
            raise ValueError(f"out must be {shape}, got {tuple(out.shape)}")
        ost = _strides(out, shape)
        spans = [(_extent(ost, shape), True)] + [
            (None, False) if x is None or not x.numel() else
            (_extent(_strides(x, shape), shape), _strides(x, shape) == ost)
            for _, x in named]
    named = [("out", out if out is not None else
              torch.empty_strided(shape, _contiguous(shape),
                                  dtype=torch.int32, device="meta"))] + named
    words = _describe(shape, named)
    batch = _numel(shape) // (rows * n) if rows * n else 0
    return _Layout(shape, [code, batch, rows, n, 0] + words, batch,
                   _pointers(named, 10), [nm for nm, _ in named], spans)


def _contiguous(shape) -> tuple:
    st, acc = [], 1
    for s in reversed(shape):
        st.append(acc)
        acc *= s
    return tuple(reversed(st))


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


def ew_args(op, a, b, q, c=None, d=None, out=None) -> tuple:
    """mod_ew's descriptor after every check of what the kernel takes (op,
    dtypes, devices, the moduli's shape, broadcasting, layouts, alignment,
    an `out` that overlaps no input unless it is one), with `out` allocated
    when not given: (words, out, batch)."""
    ins = (a, b, c, d)
    try:
        key = ("ew", op) + _key(q, out, *ins)
    except AttributeError:                    # not a tensor: the checks say
        key = None
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = _ew_layout(op, a, b, q, c, d, out)
        if key is not None:
            _remember(key, lay)
    if out is None:
        out = torch.empty(lay.shape, dtype=torch.int32, device=a.device)
    else:
        _overlaps(lay, out, ins)
    words = _fill(lay, (out,) + ins)
    words[4] = q.data_ptr()
    return words, out, lay.batch


def _raise(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES[name] += 1


def _launch(name: str, words, device) -> None:
    """K6's entry point `name` on its descriptor words, in `device`'s
    current stream; counts the launch or raises."""
    buf = struct.pack(f"{len(words)}q", *words)
    fn = getattr(_lib(), name)
    with _on(device):
        rc = fn(buf, torch.cuda.current_stream().cuda_stream)
    _raise(name, rc)


def _on(device):
    """A context that makes `device` current, when it is not already."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _launch_ew(args) -> torch.Tensor:
    words, out, batch = args
    if batch:
        _launch("mod_ew", words, out.device)
    return out


def _rs_lift_cuda(v, plan):
    m, n = plan.nl - 1, v.shape[-1]
    _residues("v", v, v.device)
    if v.shape[-2] != 1 or not v.is_contiguous() or n % 4:
        raise ValueError(f"v must be contiguous (..., 1, N) with N a "
                         f"multiple of 4, got {tuple(v.shape)}")
    out = torch.empty(v.shape[:-2] + (m, n), dtype=torch.int32,
                      device=v.device)
    batch = v.numel() // n
    if batch:
        with _on(v.device):
            rc = _lib().rs_lift(
                v.data_ptr(), out.data_ptr(), plan.qrem.data_ptr(),
                plan.qdm.data_ptr(), plan.one_s.data_ptr(), plan.half,
                batch, m, n, torch.cuda.current_stream().cuda_stream)
        _raise("rs_lift", rc)
    return out


def _finish_layout(x0, x1, lift_e, plan, f, adds, mode) -> _Layout:
    """rs_finish's checks of what the kernel takes and its descriptor,
    pointers left out."""
    m = plan.nl - 1
    _residues("lift_e", lift_e, lift_e.device)
    dev, n = lift_e.device, lift_e.shape[-1]
    if lift_e.dim() < 3 or lift_e.shape[0] != 2 or lift_e.shape[-2] != m \
            or not lift_e.is_contiguous() or n % 4:
        raise ValueError(f"lift_e must be contiguous (2, ..., {m}, N) with "
                         f"N a multiple of 4, got {tuple(lift_e.shape)}")
    lead = tuple(lift_e.shape[1:-2])
    named = []
    for name, x in (("x0", x0), ("x1", x1)):
        _residues(name, x, dev)
        if x.shape[-2] != m + 1 or x.shape[-1] != n:
            raise ValueError(f"{name} must be (..., {m + 1}, {n}), got "
                             f"{tuple(x.shape)}")
        named.append((name, x[..., :m, :]))
    if f is not None:
        _residues("f", f, dev)
        if f.shape[-2] not in (1, m + 1) or f.shape[-1] not in (1, n):
            raise ValueError(f"f must be (..., {m + 1} or 1, {n} or 1), "
                             f"got {tuple(f.shape)}")
        f = f[..., :m, :] if f.shape[-2] > 1 else f
    named.append(("f", f))
    for h, a in enumerate(adds):
        if a is not None:
            _residues(f"add{h}", a, dev)
            if a.shape[-2] not in (1, m) or a.shape[-1] not in (1, n):
                raise ValueError(f"add{h} must be (..., {m} or 1, {n} or "
                                 f"1), got {tuple(a.shape)}")
        named.append((f"add{h}", a))
    shape = lead + (m, n)
    got = broadcast_shape([shape] + [x.shape for _, x in named
                                     if x is not None])
    if got != shape:
        raise ValueError(f"the operands broadcast to {got}, lift_e holds "
                         f"{shape}")
    for name, t in (("qrem", plan.qrem), ("inv", plan.inv),
                    ("inv_s", plan.inv_s)):
        _moduli(name, t, m, dev)
    batch = _numel(shape) // (m * n) if m * n else 0
    words = [batch, m, n, MODES[mode], 0, 0, 0, 0, 0] + \
        _describe(shape, named)
    return _Layout(shape, words, batch, _pointers(named, 14),
                   [nm for nm, _ in named])


def finish_args(x0, x1, lift_e, plan, f=None, add=None,
                mode="add") -> tuple:
    """rs_finish's descriptor after every check of what the kernel takes,
    with its output allocated: (words, out, batch)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {sorted(MODES)}")
    adds = tuple(add or ()) + (None,) * (2 - len(add or ()))
    if len(adds) != 2:
        raise ValueError("add takes one addend per half")
    try:
        key = ("finish", mode) + _key(
            x0, x1, lift_e, f, *adds, plan.qrem, plan.inv, plan.inv_s)
    except AttributeError:                    # not a tensor: the checks say
        key = None
    lay = _LAYOUTS.get(key)
    if lay is None:
        lay = _finish_layout(x0, x1, lift_e, plan, f, adds, mode)
        if key is not None:
            _remember(key, lay)
    out = torch.empty_like(lift_e)
    words = _fill(lay, (x0, x1, f) + adds)
    words[4:9] = [plan.qrem.data_ptr(), plan.inv.data_ptr(),
                  plan.inv_s.data_ptr(), lift_e.data_ptr(), out.data_ptr()]
    return words, out, lay.batch


def _launch_finish(args) -> torch.Tensor:
    words, out, batch = args
    if batch:
        _launch("rs_finish", words, out.device)
    return out
