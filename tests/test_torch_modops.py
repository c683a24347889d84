"""K6, the evaluator's residue arithmetic (`ops/modops.py`,
`csrc/modops.cu`).

On the CPU: the plain `mod_ew`, `rs_lift` and `rs_finish` equal, bit for
bit, the evaluator's former int64 expressions, and the rescale built from
them equals the former `_rescale_body` and the JAX package's, at n = 256
to 4096 and nl 2 to 24, with plaintexts broadcast over a batch, (L, 1)
and (1, 1) constants, limb slices, expanded operands, one ciphertext of a
batch, and coefficients of the dropped limb on the tie v == qd // 2 and
one either side; `mul_plain`, `mul_double_sub`, `square_double_minus_one`,
the decomposition's own rows and the combo's identity terms through the
fused route equal their former compositions; the descriptors the wrapper
hands the kernels address exactly the operands' elements; the wrapper
refuses what the kernels do not take; the counters count on the CPU route
and no kernel launches there.

Tests marked `card` need a CUDA card and skip without one.  They hold
each entry point bit for bit against its plain version at the benchmark
cells' shapes (levels 12 to 24 x 8 ciphertexts, level 57 x 32, the block
products' 16 groups), the whole rescale against its former route (K2, K1
and the int64 chain), an evaluator at preset `tiny` against the same ops
on the CPU, and each entry point's calls against its launches.  On the
card's machine, which has no JAX: `python3 -m pytest --noconftest -p
no:cacheprovider tests/test_torch_modops.py -m card`.
"""

import numpy as np
import pytest
import torch

from fhe_linformer_tpu_torch.ckks.ciphertext import Ciphertext
from fhe_linformer_tpu_torch.ckks import evaluator as evm
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.config import get
from fhe_linformer_tpu_torch.ops import modops, ntt
from fhe_linformer_tpu_torch.ops.basecvt import base_convert
from fhe_linformer_tpu_torch.ops.modarith import (addmod_plain, mulmod_plain,
                                                  submod_plain)
from fhe_linformer_tpu_torch.utils.timing import (GLOBAL_TIMERS,
                                                  KERNEL_LAUNCHES)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# the cells' chain shape (scale 2^26, dnum 3) at ring 2^8, 24 scaling limbs
SMALL = dict(n=256, scale_bits=26, num_scaling=24, dnum=3, seed=5)


@pytest.fixture(scope="module")
def ctx256():
    return Context(CKKSConfig(**SMALL), device="cpu")


def _res(qs, shape, gen, device="cpu"):
    """Uniform residues (*shape) below each limb's prime on axis -2."""
    q = torch.tensor([int(x) for x in qs], dtype=torch.int64).view(-1, 1)
    x = torch.randint(0, 1 << 62, tuple(shape), generator=gen)
    return (x % q).int().to(device)


def _former(op, a, b, q, c=None, d=None):
    """The evaluator's former expressions, unchanged."""
    mul = lambda x, y: torch.remainder(x.long() * y, q).int()

    def add(x, y):
        r = x + y
        return torch.where(r >= q, r - q, r)

    if op == "mul":
        return mul(a, b)
    if op == "add":
        return add(a, b)
    if op == "sub":
        r = a - b
        return torch.where(r < 0, r + q, r)
    if op == "neg":
        return torch.where(a == 0, a, q - a)
    if op == "fma":
        return add(mul(a, b), c)
    return add(mul(a, b), mul(c, d))


def _former_rescale(ctx, c0, c1, plan):
    """The evaluator's former `_rescale_body`, unchanged (K2 and K1 on a
    CUDA tensor, the int64 chain around them)."""
    nl = plan.nl
    x = torch.stack((c0, c1))
    v = ntt.inv(x[..., nl - 1:, :], ctx.ntt, (nl - 1,))
    vm = torch.remainder(v, plan.qrem)
    lift = torch.where(v <= plan.half, vm,
                       submod_plain(vm, plan.qdm, plan.qrem))
    lift_e = ntt.fwd(lift, ctx.ntt, ctx.limb_idx(nl - 1))
    out = mulmod_plain(submod_plain(x[..., : nl - 1, :], lift_e, plan.qrem),
                       plan.inv, plan.qrem)
    return out[0], out[1]


# operand layouts: (a, b) of an (nl, n) level, B ciphertexts
def _layouts(qs, B, n, gen, device="cpu"):
    L = len(qs)
    full = lambda *lead: _res(qs, lead + (L, n), gen, device)
    wide = _res(list(qs) + [3, 5], (B, L + 2, n), gen, device)   # 2 more rows
    batch4 = full(4, B)
    return {
        "same": (full(B), full(B)),
        "plaintext": (full(B), full()),                     # (L, n) over B
        "batched_pt": (full(), full(B)),                    # a broadcast
        "const": (full(B), _res(qs, (L, 1), gen, device)),  # (L, 1)
        "one": (full(B), torch.full((1, 1), 2, dtype=torch.int32,
                                    device=device)),        # (1, 1)
        "limb_slice": (wide[..., :L, :], full(B)),          # rows of more
        "one_ct": (batch4[1], batch4[2]),                   # x[c]
        "expanded": (full(1).expand(B, L, n), full(B)),
        "two_axes": (full(3, B), full(3, 1)),               # bcast inner
        "strided_batch": (full(2 * B)[::2], full(1)),       # every other
    }


OPS_ARGS = {"mul": 2, "add": 2, "sub": 2, "neg": 1, "fma": 3, "dot": 4}
LAYOUTS = ["same", "plaintext", "batched_pt", "const", "one", "limb_slice",
           "one_ct", "expanded", "two_axes", "strided_batch"]


def _operands(op, lay, qs, B, n, gen, device="cpu"):
    a, b = _layouts(qs, B, n, gen, device)[lay]
    k = OPS_ARGS[op]
    extra = [_res(qs, (B, len(qs), n), gen, device),
             _res(qs, (len(qs), 1), gen, device)]
    return ([a, b] + extra)[:k] if k > 1 else [a]


def _call(op, ops, q, **kw):
    a, b, c, d = list(ops) + [None] * (4 - len(ops))
    return modops.mod_ew(op, a, b, q, c, d, **kw)


@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("op", sorted(OPS_ARGS))
def test_plain_mod_ew_matches_former(ctx256, op, lay):
    nl = 5
    qs = ctx256.qs[:nl]
    q = ctx256.mod(ctx256.limb_idx(nl))
    gen = torch.Generator().manual_seed(len(op) * 31 + LAYOUTS.index(lay))
    ops = _operands(op, lay, qs, 3, 256, gen)
    want = _former(op, *ops[:1], *(ops[1:2] or [None]), q, *ops[2:])
    got = _call(op, ops, q)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    buf = torch.zeros((2,) + want.shape, dtype=torch.int32)
    got = _call(op, ops, q, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], want) and not buf[0].any()


@pytest.mark.parametrize("nl", [2, 12, 24])
@pytest.mark.parametrize("n", [256, 4096])
def test_plain_entries_at_levels(n, nl):
    """mul and dot (the tensor's middle term) at ring 2^8 and 2^12, nl 2 to
    24, a plaintext broadcast over 8 ciphertexts."""
    ctx = Context(CKKSConfig(n=n, scale_bits=26, num_scaling=24, dnum=3,
                             seed=5), device="cpu")
    qs, q = ctx.qs[:nl], ctx.mod(ctx.limb_idx(nl))
    gen = torch.Generator().manual_seed(n + nl)
    a0, a1, b0, b1 = (_res(qs, (8, nl, n), gen) for _ in range(4))
    pt = _res(qs, (nl, n), gen)
    assert torch.equal(modops.mod_ew("mul", a0, pt, q),
                       _former("mul", a0, pt, q))
    assert torch.equal(modops.mod_ew("dot", a0, b1, q, a1, b0),
                       _former("dot", a0, b1, q, a1, b0))


def _addressed(ops_words, lead, tensors, shape):
    """Each tensor re-read from its storage at the descriptor's pointer and
    strides, against the tensor broadcast to `shape` with its leading axes
    merged as the descriptor merges them."""
    nd = lead[0]
    sizes = lead[1: 1 + nd]
    for w, x in zip(ops_words, tensors):
        if x is None:
            assert w[0] == 0
            continue
        base = x.untyped_storage().data_ptr()
        off = (w[0] - base) // 4
        assert (w[0] - base) % 4 == 0 and off >= 0
        st = list(reversed(w[3: 3 + nd])) + [w[1], w[2]]
        size = list(reversed(sizes)) + list(shape[-2:])
        got = torch.as_strided(
            torch.empty(0, dtype=torch.int32).set_(x.untyped_storage()),
            size, st, off)
        want = x.expand(shape).reshape(size)
        assert torch.equal(got, want)


@pytest.mark.parametrize("lay", LAYOUTS)
def test_descriptor_addresses_operands(ctx256, lay):
    """mod_ew's words: every operand (and a strided `out`) is read at the
    elements it holds, with its leading axes merged to at most 4."""
    nl = 4
    qs, q = ctx256.qs[:nl], ctx256.mod(ctx256.limb_idx(nl))
    gen = torch.Generator().manual_seed(7 + LAYOUTS.index(lay))
    a, b, c = _operands("fma", lay, qs, 3, 256, gen)
    shape = torch.broadcast_shapes(a.shape, b.shape, c.shape)
    buf = torch.zeros((2,) + shape, dtype=torch.int32)
    words, out, batch = modops.ew_args("fma", a, b, q, c, out=buf[1])
    assert out.data_ptr() == buf[1].data_ptr()
    assert words[:5] == [4, batch, nl, 256, q.data_ptr()]
    lead, rest = words[5: 10], words[10:]
    opw = [rest[7 * i: 7 * i + 7] for i in range(5)]
    assert batch == int(np.prod(lead[1:]))
    _addressed(opw, lead, [out, a, b, c, None], shape)


def test_descriptor_merges_axes(ctx256):
    """Contiguous operands merge to one leading axis; a plaintext shared by
    the batch keeps stride 0; a limb slice keeps its entry stride."""
    qs, q = ctx256.qs[:3], ctx256.mod(ctx256.limb_idx(3))
    gen = torch.Generator().manual_seed(2)
    a = _res(qs, (2, 4, 5, 3, 256), gen)
    words, _, batch = modops.ew_args("add", a, a.clone(), q)
    assert batch == 40 and words[5:10] == [1, 40, 1, 1, 1]
    pt = _res(qs, (3, 256), gen)
    wide = _res(list(qs) + [3], (40, 4, 256), gen)[..., :3, :]
    words, _, _ = modops.ew_args("mul", wide, pt, q)
    b_words = words[10 + 14: 10 + 21]
    a_words = words[10 + 7: 10 + 14]
    assert words[5:7] == [1, 40]
    assert a_words[:4] == [wide.data_ptr(), 256, 1, 4 * 256]
    assert b_words[1:4] == [256, 1, 0]


def test_rescale_matches_former_and_jax(ctx256):
    """modops.rescale (plain route) against the former `_rescale_body` and
    the JAX package's, at nl 2 to 24, the dropped limb's coefficients on
    the tie qd // 2 and one either side in some columns."""
    import jax.numpy as jnp
    from fhe_linformer_tpu.ckks import CKKSConfig as JConfig
    from fhe_linformer_tpu.ckks import Context as JContext
    from fhe_linformer_tpu.ckks import evaluator as jevm
    jctx = JContext(JConfig(**SMALL))
    u32 = lambda t: np.asarray(t.numpy()).astype(np.uint32)
    for nl in (2, 3, 7, 13, 24):
        plan = ctx256.rescale_tables(nl)
        gen = torch.Generator().manual_seed(40 + nl)
        qs = ctx256.qs[:nl]
        c0, c1 = (_res(qs, (2, nl, 256), gen) for _ in range(2))
        qd, half = int(qs[-1]), plan.half
        v = torch.randint(0, qd, (2, 1, 256), generator=gen, dtype=torch.int64)
        v[..., :30] = half
        v[..., 30:40] = half + 1
        v[..., 40:50] = half - 1
        c0[..., nl - 1:, :] = ntt.fwd(v.int(), ctx256.ntt, (nl - 1,))
        got = modops.rescale(c0, c1, ctx256.ntt, plan)
        want = _former_rescale(ctx256, c0, c1, plan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(
            ntt.inv(c0[..., nl - 1:, :], ctx256.ntt, (nl - 1,)), v.int())
        j0, j1 = jevm._rescale_core(jnp.asarray(u32(c0)), jnp.asarray(u32(c1)),
                                    jctx.rescale_tables(nl))
        np.testing.assert_array_equal(u32(got[0]), np.asarray(j0))
        np.testing.assert_array_equal(u32(got[1]), np.asarray(j1))


def test_rs_lift_tie():
    """The lift takes v mod q_i for v <= qd // 2 (the tie included) and
    v - qd mod q_i above, as the former expression."""
    ctx = Context(CKKSConfig(**SMALL), device="cpu")
    plan = ctx.rescale_tables(9)
    qd = int(ctx.qs[8])
    v = torch.tensor([0, 1, plan.half - 1, plan.half, plan.half + 1, qd - 1,
                      5, 7], dtype=torch.int32).view(1, 1, 8)
    got = modops.rs_lift(v, plan)
    q = plan.qrem.long()
    want = torch.where(v.long() <= qd // 2, v.long() % q, (v.long() - qd) % q)
    assert torch.equal(got.long(), want)


FINISH = {"plain": (False, None), "factor": (True, None),
          "add": (False, "add"), "rsub": (True, "rsub"), "const": (True, "c")}
# rs_finish's modes, as the former expressions
STEP = {"add": addmod_plain, "rsub": lambda r, a, q: submod_plain(a, r, q)}


@pytest.mark.parametrize("case", sorted(FINISH))
def test_plain_rescale_fused(ctx256, case):
    """rescale with a factor and an addend in the finish equals the former
    product, rescale and add / sub one after the other; x read from limb
    slices of larger tensors, the factor a plaintext, its batch or a
    constant; the addend added or the result subtracted from it."""
    fac, add = FINISH[case]
    nl = 6
    plan = ctx256.rescale_tables(nl)
    qs, q = ctx256.qs[:nl], ctx256.mod(ctx256.limb_idx(nl))
    gen = torch.Generator().manual_seed(len(case))
    x = _res(list(qs) + [3], (2, 3, nl + 1, 256), gen)[..., :nl, :]
    f = None
    if fac:
        f = {"factor": _res(qs, (nl, 256), gen), "rsub": _res(qs, (3, nl, 256),
             gen), "const": _res(qs, (nl, 1), gen)}[case]
    m = nl - 1
    terms = None
    if add == "add":
        terms = (_res(qs[:m], (3, m, 256), gen), None)
    elif add == "rsub":
        terms = tuple(_res(qs[:m], (3, m, 256), gen) for _ in range(2))
    elif add == "c":
        terms = (_res(qs[:m], (m, 1), gen), None)
    mode = "rsub" if add == "rsub" else "add"
    got = modops.rescale(x[0], x[1], ctx256.ntt, plan, f, terms, mode=mode)
    c0, c1 = x[0], x[1]
    if f is not None:
        c0, c1 = mulmod_plain(c0, f, q), mulmod_plain(c1, f, q)
    want = list(_former_rescale(ctx256, c0, c1, plan))
    for h, t in enumerate(terms or ()):
        if t is not None:
            want[h] = STEP[mode](want[h], t, plan.qrem)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def ev256():
    cfg = CKKSConfig(n=256, scale_bits=26, num_scaling=8, dnum=2, seed=8)
    ctx = Context(cfg, device="cpu")
    return Evaluator(ctx, generate_keys(ctx, rotations=(1, 2, 3)))


def _former_relin_product(ctx, a0, a1, b0, b1, relin, ks):
    q = ks.q_act
    d0 = mulmod_plain(a0, b0, q)
    d1 = addmod_plain(mulmod_plain(a0, b1, q), mulmod_plain(a1, b0, q), q)
    return evm._relin(ctx, mulmod_plain(a1, b1, q), relin, ks, add=(d0, d1))


def _former_node(ev, a, b, c, wide):
    """The former mul_double_sub (c given) or square_double_minus_one
    (c None), unchanged but for the names."""
    ctx = ev.ctx
    nl = a.nl
    ks = ctx.ks_tables(nl)
    c0, c1 = _former_relin_product(ctx, a.c0, a.c1, b.c0, b.c1,
                                   ev.keys.relin, ks)
    q = ks.q_act
    c0, c1 = addmod_plain(c0, c0, q), addmod_plain(c1, c1, q)
    nl_out = nl - 2 if wide else nl - 1
    for m in range(nl, nl_out, -1):
        c0, c1 = _former_rescale(ctx, c0, c1, ctx.rescale_tables(m))
    s_prod = a.scale * b.scale
    s_out = s_prod / float(ctx.qs[nl - 1])
    if wide:
        s_out /= float(ctx.qs[nl - 2])
    if c is None:
        qs = np.asarray(ctx.qs[:nl_out], np.int64)
        m1 = ctx.tensor(((-int(round(s_out))) % qs).reshape(-1, 1)
                        .astype(np.int32))
        return addmod_plain(c0, m1, ctx.rescale_tables(nl_out + 1).qrem), c1
    c = ev.drop_to(c, nl_out + 1)
    v_c = int(round(s_out * float(ctx.qs[nl_out]) / c.scale))
    qs_c = np.asarray(ctx.qs[:nl_out + 1], np.int64).reshape(-1, 1)
    vc = ctx.tensor((v_c % qs_c).astype(np.int32))
    qc = ctx.mod(ctx.limb_idx(nl_out + 1))
    plan_c = ctx.rescale_tables(nl_out + 1)
    f0, f1 = _former_rescale(ctx, mulmod_plain(c.c0, vc, qc),
                             mulmod_plain(c.c1, vc, qc), plan_c)
    return submod_plain(c0, f0, plan_c.qrem), submod_plain(c1, f1,
                                                           plan_c.qrem)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_evaluator_fused_nodes(ev256, wide):
    """mul_double_sub and square_double_minus_one (the doubling in the first
    rescale's factor, the last term in the last finish) equal their former
    compositions, also with c one ciphertext against a batch and a batch
    against one; mul_plain with a plaintext, a batch of them and a
    constant equals the former product then rescale."""
    ev = ev256
    rng = np.random.default_rng(11 + wide)
    slots = ev.ctx.cfg.slots
    a = ev.encrypt(rng.uniform(-1, 1, (2, slots)), batch=True)
    b = ev.encrypt(rng.uniform(-1, 1, (2, slots)), batch=True)
    c = ev.encrypt(rng.uniform(-1, 1, (2, slots)), batch=True)
    one = ev.encrypt(rng.uniform(-1, 1, slots))
    for got, want in ((ev.mul_double_sub(a, b, c, wide=wide),
                       _former_node(ev, a, b, c, wide)),
                      (ev.mul_double_sub(a, b, one, wide=wide),
                       _former_node(ev, a, b, one, wide)),
                      (ev.mul_double_sub(one, one, c, wide=wide),
                       _former_node(ev, one, one, c, wide)),
                      (ev.square_double_minus_one(a, wide=wide),
                       _former_node(ev, a, a, None, wide))):
        assert torch.equal(got.c0, want[0]) and torch.equal(got.c1, want[1])
    nl = a.nl
    q = ev.ctx.mod(ev.ctx.limb_idx(nl))
    for pt in (ev.encode(rng.uniform(-1, 1, slots), nl=nl),
               ev.encode(rng.uniform(-1, 1, (2, slots)), nl=nl, batch=True),
               ev.encode_const(0.75, nl, 2.0 ** 20)):
        got = ev.mul_plain(a, pt)
        want = _former_rescale(ev.ctx, mulmod_plain(a.c0, pt.data, q),
                               mulmod_plain(a.c1, pt.data, q),
                               ev.ctx.rescale_tables(nl))
        assert torch.equal(got.c0, want[0]) and torch.equal(got.c1, want[1])


def test_evaluator_own_rows_and_identity_terms(ev256):
    """The decomposition's own rows written in place equal the former
    product and copy; a combo with an identity term (K6's in-place
    multiply-add) equals the former mul_plain and add."""
    ev, ctx = ev256, ev256.ctx
    rng = np.random.default_rng(5)
    slots = ctx.cfg.slots
    ct = ev.encrypt(rng.uniform(-1, 1, (3, slots)), batch=True)
    ks = ctx.ks_tables(ct.nl)
    cx = ntt.inv(ct.c1, ctx.ntt, ks.act_idx)
    y = evm._ks_decompose(ctx, cx, ks, ct.c1)
    want = ntt.fwd(base_convert(cx, ks.bc), ctx.ntt, ks.dig_limbs)
    own = mulmod_plain(ct.c1, ks.own, ks.q_act)
    for j, g in enumerate(ks.groups):
        want[j, ..., g[0]:g[-1] + 1, :] = own[..., g[0]:g[-1] + 1, :]
    assert torch.equal(y, want)
    items = [(r, ev.encode_coeff_cached(("k6", r), rng.uniform(-1, 1, slots)))
             for r in (0, 1, 2)]
    got = ev.rotate_combo(ct, items)
    rot = ev.rotate_combo(ct, items[1:])
    t = ev._pt_q(items[0][1], ks).data
    q = ks.q_act
    for g, w in ((got.c0, addmod_plain(rot.c0, mulmod_plain(ct.c0, t, q), q)),
                 (got.c1, addmod_plain(rot.c1, mulmod_plain(ct.c1, t, q), q))):
        assert torch.equal(g, w)


# what the wrappers must refuse, and the words of the message
BAD = {"dtype": "b must be torch.int32", "op": "unknown op",
       "missing": "fma takes 3 operands", "extra": "mul takes 2 operands",
       "moduli": "q must be contiguous", "broadcast": "do not broadcast",
       "coefficient stride": "coefficients must be contiguous",
       "misaligned": "aligned", "out shape": "out must be",
       "out overlap": "out overlaps a", "axes": "more than 4"}


def _bad_ew(what, ctx, gen, device="cpu"):
    qs, q = ctx.qs[:4], ctx.mod(ctx.limb_idx(4))
    a, b = (_res(qs, (3, 4, 256), gen, device) for _ in range(2))
    call = dict(op="mul", a=a, b=b, q=q)
    if what == "dtype":
        call["b"] = b.long()
    elif what == "op":
        call["op"] = "div"
    elif what == "missing":
        call["op"] = "fma"
    elif what == "extra":
        call["c"] = a
    elif what == "moduli":
        call["q"] = ctx.mod(ctx.limb_idx(3))
    elif what == "broadcast":
        call["b"] = b[:2]
    elif what == "coefficient stride":
        call["a"] = a.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif what == "misaligned":
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=device)
        call["a"] = buf[1:].view(a.shape).copy_(a)
    elif what == "out shape":
        call["out"] = torch.empty((3, 5, 256), dtype=torch.int32,
                                  device=device)
    elif what == "out overlap":
        big = torch.zeros((3 * 4 + 1) * 256, dtype=torch.int32,
                          device=device)
        call["a"] = big[:3 * 4 * 256].view(3, 4, 256)
        call["out"] = big[256:].view(3, 4, 256)
    elif what == "axes":
        x = _res(qs, (2, 2, 2, 2, 2, 4, 256), gen, device)
        call["a"] = x.permute(0, 2, 1, 4, 3, 5, 6)
        call["b"] = x
    return call


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrapper_refuses(ctx256, what):
    """Each refusal, twice; the pointers' checks (alignment, overlap) also
    after a sound call of the same layout has been checked and kept."""
    gen = torch.Generator().manual_seed(3)
    call = _bad_ew(what, ctx256, gen)
    if what in ("misaligned", "out overlap"):
        sound = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in call.items()}
        modops.ew_args(sound.pop("op"), **sound)
    for _ in range(2):
        with pytest.raises((TypeError, ValueError), match=BAD[what]):
            modops.ew_args(**call)


FINISH_BAD = {"lift shape": "lift_e must be", "x rows": "x1 must be",
              "factor rows": "f must be", "addend rows": "add0 must be",
              "batch": "broadcast to", "mode": "unknown mode"}


@pytest.mark.parametrize("what", sorted(FINISH_BAD))
def test_finish_wrapper_refuses(ctx256, what):
    nl, m = 5, 4
    plan = ctx256.rescale_tables(nl)
    qs = ctx256.qs[:nl]
    gen = torch.Generator().manual_seed(8)
    x0, x1 = (_res(qs, (3, nl, 256), gen) for _ in range(2))
    lift = _res(qs[:m], (2, 3, m, 256), gen)
    call = dict(x0=x0, x1=x1, lift_e=lift, plan=plan)
    if what == "lift shape":
        call["lift_e"] = lift[:, :, :3]
    elif what == "x rows":
        call["x1"] = x1[..., :m, :]
    elif what == "factor rows":
        call["f"] = _res(qs[:3], (3, 256), gen)
    elif what == "addend rows":
        call["add"] = (_res(qs, (nl, 256), gen), None)
    elif what == "batch":
        call["x0"] = _res(qs, (4, 3, nl, 256), gen)
    elif what == "mode":
        call["mode"] = "sub"
    with pytest.raises((TypeError, ValueError), match=FINISH_BAD[what]):
        modops.finish_args(**call)


def test_counts(ev256):
    """Each CPU call counts once and launches nothing; a rescale is one
    rs_lift and one rs_finish, a mul_plain the same plus its top-limb
    product, a product one `dot` and a `mul` per own-row group."""
    ev, ctx = ev256, ev256.ctx
    names = ("mod_ew", "rs_lift", "rs_finish")
    before = {k: GLOBAL_TIMERS.counts[k] for k in names}
    launched = dict(KERNEL_LAUNCHES)
    rng = np.random.default_rng(2)
    ct = ev.encrypt(rng.uniform(-1, 1, ctx.cfg.slots))
    ev.rescale(ct)
    d = {k: GLOBAL_TIMERS.counts[k] - before[k] for k in names}
    assert d == {"mod_ew": 0, "rs_lift": 1, "rs_finish": 1}
    ev.mul_plain(ct, ev.encode(rng.uniform(-1, 1, ctx.cfg.slots), nl=ct.nl))
    d = {k: GLOBAL_TIMERS.counts[k] - before[k] for k in names}
    assert d == {"mod_ew": 2, "rs_lift": 2, "rs_finish": 2}
    ev.mul(ct, ct, rescale=False)
    groups = len(ctx.ks_tables(ct.nl).groups)
    assert GLOBAL_TIMERS.counts["mod_ew"] - before["mod_ew"] == 2 + 1 + groups
    assert KERNEL_LAUNCHES == launched


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture(scope="module")
def cells():
    """The cells' chain at n = 2^15 (tables only), on the card."""
    if not torch.cuda.is_available():
        return None
    return Context(get("linformer-boot-w").ckks, device="cuda")


def _held(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _card_ew(ctx, op, lay, nl, B, seed):
    qs, q = ctx.qs[:nl], ctx.mod(ctx.limb_idx(nl))
    gen = torch.Generator().manual_seed(seed)
    ops = _operands(op, lay, qs, B, ctx.cfg.n, gen, "cuda")
    calls, fired = GLOBAL_TIMERS.counts["mod_ew"], KERNEL_LAUNCHES["mod_ew"]
    got = _call(op, ops, q)
    want = modops.mod_ew_plain(op, *ops[:1], *(ops[1:2] or [None]), q,
                               *ops[2:])
    _held(got, want)
    assert GLOBAL_TIMERS.counts["mod_ew"] - calls == \
        KERNEL_LAUNCHES["mod_ew"] - fired == 1


@pytest.mark.card
@pytest.mark.parametrize("lay", LAYOUTS)
@pytest.mark.parametrize("op", sorted(OPS_ARGS))
def test_card_mod_ew_layouts(card, cells, op, lay):
    _card_ew(cells, op, lay, 23, 8, len(op) + LAYOUTS.index(lay))


@pytest.mark.card
@pytest.mark.parametrize("nl, B", [(12, 8), (24, 8), (57, 32), (2, 1)])
@pytest.mark.parametrize("op", sorted(OPS_ARGS))
def test_card_mod_ew_levels(card, cells, op, nl, B):
    _card_ew(cells, op, "same", nl, B, nl + B)
    _card_ew(cells, op, "plaintext", nl, B, nl + B + 1)


def _card_rescale(ctx, nl, lead, seed, fac=None, add=None, pair=False):
    """modops.rescale on the card against its former route (K2, K1 and the
    int64 chain on the same tensors), each entry point's calls equal to
    its launches."""
    plan = ctx.rescale_tables(nl)
    qs, q = ctx.qs[:nl], ctx.mod(ctx.limb_idx(nl))
    n = ctx.cfg.n
    gen = torch.Generator().manual_seed(seed)
    if pair:          # the halves of one earlier rescale, read in place
        x = _res(qs, (2,) + lead + (nl, n), gen, "cuda")
        c0, c1 = x[0], x[1]
    else:             # limb slices of larger tensors
        c0, c1 = (_res(list(qs) + [3], lead + (nl + 1, n), gen,
                       "cuda")[..., :nl, :] for _ in range(2))
    f = {None: None, "pt": lambda: _res(qs, (nl, n), gen, "cuda"),
         "const": lambda: _res(qs, (nl, 1), gen, "cuda"),
         "two": lambda: ctx.factor(2)}[fac]
    f = f() if callable(f) else f
    m = nl - 1
    terms = None if add is None else \
        (_res(qs[:m], lead + (m, n), gen, "cuda"),
         _res(qs[:m], (m, 1), gen, "cuda"))
    names = ("mod_ew", "rs_lift", "rs_finish")
    calls = {k: GLOBAL_TIMERS.counts[k] for k in names}
    fired = {k: KERNEL_LAUNCHES[k] for k in names}
    got = modops.rescale(c0, c1, ctx.ntt, plan, f, terms,
                         mode=add or "add")
    torch.cuda.synchronize()
    for k in names:
        assert GLOBAL_TIMERS.counts[k] - calls[k] == \
            KERNEL_LAUNCHES[k] - fired[k]
    assert KERNEL_LAUNCHES["rs_finish"] - fired["rs_finish"] == 1
    if f is not None:
        c0, c1 = mulmod_plain(c0, f, q), mulmod_plain(c1, f, q)
    want = list(_former_rescale(ctx, c0, c1, plan))
    for h, t in enumerate(terms or ()):
        want[h] = STEP[add](want[h], t, plan.qrem)
    _held(got[0], want[0])
    _held(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("nl, lead", [
    (12, (8,)), (23, (8,)), (24, (8,)),      # the cells' chunks of 8 cts
    (57, (32,)),                             # the bootstrap's top levels
    (24, (16, 2)),                           # the block products' 16 groups
    (2, (1,)), (13, ())],
    ids=["l12", "l23", "l24", "l57", "groups16", "l2", "single"])
@pytest.mark.parametrize("fac, add", [(None, None), ("pt", None),
                                      ("const", None), ("two", "add"),
                                      ("const", "rsub")],
                         ids=["plain", "pt", "const", "node_add",
                              "node_rsub"])
def test_card_rescale(card, cells, nl, lead, fac, add):
    _card_rescale(cells, nl, lead, nl + len(lead), fac, add)


@pytest.mark.card
@pytest.mark.parametrize("fac", [None, "pt"])
def test_card_rescale_pair(card, cells, fac):
    """Halves that follow each other in one storage: K2 reads the top limb
    in place (no stack), the factor's product is one launch."""
    _card_rescale(cells, 23, (8,), 5, fac, None, pair=True)


@pytest.mark.card
def test_card_rs_tie(card, cells):
    """rs_lift on coefficients at the tie qd // 2 and one either side."""
    plan = cells.rescale_tables(23)
    qd = int(cells.qs[22])
    gen = torch.Generator().manual_seed(1)
    v = torch.randint(0, qd, (16, 1, cells.cfg.n), generator=gen,
                      dtype=torch.int64)
    v[..., :64] = plan.half
    v[..., 64:96] = plan.half + 1
    v[..., 96:128] = plan.half - 1
    v = v.int().cuda()
    _held(modops.rs_lift(v, plan), modops.rs_lift_plain(v, plan))


@pytest.mark.card
@pytest.mark.parametrize("what", sorted(BAD))
def test_card_wrapper_refuses(card, what):
    """The same refusals on the card, before any launch, twice: a layout
    the wrapper has checked once is held to its pointers again."""
    ctx = Context(CKKSConfig(**SMALL), device="cuda")
    for _ in range(2):
        call = _bad_ew(what, ctx, torch.Generator().manual_seed(3), "cuda")
        before = dict(KERNEL_LAUNCHES)
        with pytest.raises((TypeError, ValueError), match=BAD[what]):
            modops.mod_ew(call.pop("op"), **call)
        assert KERNEL_LAUNCHES == before


@pytest.mark.card
def test_card_evaluator(card):
    """The evaluator's ops at preset tiny's shapes (n = 2^8) on the card
    equal the same ops on the CPU, and K6's calls equal its launches."""
    cfg = get("tiny").ckks
    evs = []
    for device in ("cuda", "cpu"):
        ctx = Context(cfg, device=device)
        evs.append(Evaluator(ctx, generate_keys(ctx, rotations=(1, 2, 3))))
    rng = np.random.default_rng(3)
    slots = cfg.n // 2
    cpu = evs[1]
    cs = [cpu.encrypt(rng.uniform(-1, 1, (2, slots)), batch=True)
          for _ in range(3)]
    vals = rng.uniform(-1, 1, slots)
    names = ("mod_ew", "rs_lift", "rs_finish")
    outs = []
    for ev in evs:
        a, b, c = (Ciphertext(x.c0.to(ev.ctx.device), x.c1.to(ev.ctx.device),
                              x.nl, x.scale) for x in cs)
        items = [(r, ev.encode_coeff_cached(("k6", r), vals * (r + 1)))
                 for r in (0, 1, 2)]
        pt = ev.encode(vals, nl=a.nl)
        calls = {k: GLOBAL_TIMERS.counts[k] for k in names}
        fired = {k: KERNEL_LAUNCHES[k] for k in names}
        outs.append([ev.add(a, b), ev.sub(a, b), ev.neg(a),
                     ev.add_plain(a, pt), ev.mul_plain(a, pt),
                     ev.mul_plain(a, pt, rescale=False),
                     ev.mul_scalar_int(a, 3), ev.rescale(a), ev.mul(a, b),
                     ev.mul_double_sub(a, b, c),
                     ev.mul_double_sub(a, b, c, wide=True),
                     ev.square_double_minus_one(a),
                     ev.square_double_minus_one(a, wide=True),
                     ev.rotate_combo(a, items),
                     ev.rotate_accumulate_tree(a, [1, 2])])
        if ev is evs[0]:
            torch.cuda.synchronize()
            for k in names:
                assert GLOBAL_TIMERS.counts[k] - calls[k] == \
                    KERNEL_LAUNCHES[k] - fired[k] > 0, k
    for got, want in zip(*outs):
        assert torch.equal(got.c0.cpu(), want.c0)
        assert torch.equal(got.c1.cpu(), want.c1)



@pytest.mark.card
@pytest.mark.parametrize("op, bad", [("mulmod", "a"), ("mulmod", "b"),
                                     ("addmod", "a"), ("addmod", "b"),
                                     ("submod", "a"), ("submod", "b"),
                                     ("negmod", "a")])
def test_card_modarith_refuses_int64(card, op, bad):
    """On the card `ops/modarith.py` sends every tensor to K6, which takes
    int32 operands only: an int64 residue or operand raises before any
    launch instead of taking the int64 chain unseen."""
    from fhe_linformer_tpu_torch.ops import modarith
    q = torch.tensor([[97], [101]], dtype=torch.int32, device="cuda")
    x = torch.ones((2, 8), dtype=torch.int32, device="cuda")
    a, b = (x.long(), x) if bad == "a" else (x, x.long())
    before = dict(KERNEL_LAUNCHES)
    with pytest.raises(TypeError, match=f"{bad} must be torch.int32"):
        if op == "negmod":
            modarith.negmod(a, q)
        else:
            getattr(modarith, op)(a, b, q)
    assert KERNEL_LAUNCHES == before


@pytest.mark.card
def test_card_plain_references_stay_plain(card):
    """The plain versions of K5 and K6 on CUDA tensors are plain torch:
    they launch no K6 and count no K6 call."""
    from fhe_linformer_tpu_torch.ops import moddown
    ctx = Context(get("linformer-boot-w").ckks, device="cuda")
    nl, n = 12, ctx.cfg.n
    ks, plan = ctx.ks_tables(nl), ctx.rescale_tables(nl)
    gen = torch.Generator().manual_seed(7)
    x = _res([ctx.basis[i] for i in ks.tgt_idx], (2, len(ks.tgt_idx), n),
             gen, "cuda")
    c = _res(ctx.qs[:nl], (2, nl, n), gen, "cuda")
    names = ("mod_ew", "rs_lift", "rs_finish")
    calls = {k: GLOBAL_TIMERS.counts[k] for k in names}
    before = dict(KERNEL_LAUNCHES)
    moddown.mod_down_plain(x, ctx.ntt, ks, add=(c[0], None))
    v = ntt.inv(c[:, nl - 1:], ctx.ntt, (nl - 1,))
    lift_e = ntt.fwd(modops.rs_lift_plain(v, plan), ctx.ntt,
                     tuple(range(nl - 1)))
    modops.rs_finish_plain(c[0], c[1], lift_e, plan, f=c[1])
    modops.mod_ew_plain("dot", c[0], c[1], ks.q_act, c[1], c[0])
    torch.cuda.synchronize()
    assert {k: GLOBAL_TIMERS.counts[k] for k in names} == calls
    assert all(KERNEL_LAUNCHES[k] == before[k] for k in names)
