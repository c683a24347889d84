"""K5, the key switch's mod-down passes (`ops/moddown.py`,
`csrc/moddown.cu`).

On the CPU: the plain route equals, bit for bit, the evaluator's former
`_mod_down` with the callers' former `addmod` of their c0 or d0 / d1
terms, and the JAX package's `_mod_down`, at nl 1, 4, 12 and 59 with 20
special primes, with 1 to 3 leading axes, the key halves on axis 0 or 1,
with and without addends, x a limb slice of a larger tensor; K5's Shoup
constants equal the JAX package's; the wrapper refuses what the kernels do
not take; the evaluator counts one mod-down per key switch it runs.

Tests marked `card` need a CUDA card and skip without one.  They hold each
of K5's three entry points and the whole mod-down bit for bit against the
plain route (which runs K1-K3 and the torch chain) at the benchmark cells'
shapes (n = 2^15, levels 7 to 59, batches of 2 to 64 key halves, the
combo's groups on axis 0 with the halves on axis 1), on overflow columns
built to land on a float32 rounding tie and one ulp either side, at
n = 2^16 and 2^8, and run an evaluator at preset `tiny` on the card
against the same ops on the CPU.  On the card's machine, which has no JAX:
`python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_moddown.py -m card`.
"""

import math

import numpy as np
import pytest
import torch

from fhe_linformer_tpu_torch.ckks.ciphertext import Ciphertext
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.config import get
from fhe_linformer_tpu_torch.ops import moddown, ntt
from fhe_linformer_tpu_torch.ops.basecvt import base_convert
from fhe_linformer_tpu_torch.ops.modarith import addmod, mulmod, submod
from fhe_linformer_tpu_torch.utils.timing import (GLOBAL_TIMERS,
                                                  KERNEL_LAUNCHES)

K_SP = 20                   # the cells' special primes (59 limbs, dnum 3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# the cells' chain shape (59 scaling limbs, 20 specials) at ring 2^8
SMALL = dict(n=256, scale_bits=26, num_scaling=58, dnum=3, seed=5)


def _x(ctx, nl, lead, gen, pad=0):
    """Uniform residues (*lead, nl + k, n) over Q_l * P; with `pad`, the
    limb slice [pad, pad + nl + k) of a tensor with 2 pad more rows."""
    qs = [ctx.basis[i] for i in ctx.limb_idx(nl, specials=True)]
    rows = [1] * pad + qs + [1] * pad
    q = torch.tensor(rows, dtype=torch.int64).view(-1, 1)
    full = torch.randint(0, 1 << 62, tuple(lead) + (len(rows), ctx.cfg.n),
                         generator=gen)
    full = (full % q).int().to(ctx.device)
    return full[..., pad: pad + len(qs), :] if pad else full


def _addend(ctx, nl, shape, gen):
    q = torch.tensor(ctx.qs[:nl], dtype=torch.int64).view(-1, 1)
    a = torch.randint(0, 1 << 62, tuple(shape) + (nl, ctx.cfg.n),
                      generator=gen)
    return (a % q).int().to(ctx.device)


def _former_md_overflow(w, mdq40):
    """The evaluator's `_md_overflow` before K5, unchanged."""
    w = w.long()
    a = (w & 0xFFFF) * mdq40
    b = (w >> 16) * mdq40
    al, ahbb = ((a & 0xFFFF).sum(-2, keepdim=True),
                ((a >> 16) + b).sum(-2, keepdim=True))
    s = al.float() * (2.0 ** -40) + ahbb.float() * (2.0 ** -24)
    return torch.round(s).int()


def _former_mod_down(ctx, x, ks, add=None, half_dim=0):
    """The evaluator's `_mod_down` before K5, unchanged, then each caller's
    `addmod(term, k[h], q)`."""
    nl = ks.nl
    vp = ntt.inv(x[..., nl:, :], ctx.ntt, ks.sp_idx)
    w = mulmod(vp, ks.pfold, ks.q_sp)
    v = _former_md_overflow(w, ks.mdq40)
    y = base_convert(w, ks.md, prefolded=True)[0]
    y = submod(y, mulmod(v, ks.pmod, ks.q_act), ks.q_act)
    y_e = ntt.fwd(y, ctx.ntt, ks.act_idx)
    k = mulmod(submod(x[..., :nl, :], y_e, ks.q_act), ks.pinv, ks.q_act)
    halves = [k.select(half_dim, h) for h in range(2)]
    for h, a in enumerate(add or ()):
        if a is not None:
            halves[h] = addmod(a, halves[h], ks.q_act)
    return torch.stack(halves, half_dim)


@pytest.fixture(scope="module")
def ctx256():
    return Context(CKKSConfig(**SMALL), device="cpu")


# leading shapes with the halves' axis: (halves on 0), (G, halves, batch)
LEADS = {"one": ((2,), 0), "two": ((2, 3), 0), "three": ((3, 2, 2), 1)}


@pytest.mark.parametrize("adds", [(False, False), (True, False),
                                  (True, True)], ids=["none", "c0", "d0d1"])
@pytest.mark.parametrize("lead", sorted(LEADS))
@pytest.mark.parametrize("nl", [1, 4, 12, 59])
def test_plain_matches_former(ctx256, nl, lead, adds):
    """x a limb slice of a larger tensor (rows n apart, entries nl + k + 2
    rows apart), as K2 and K5 read the evaluator's accumulators."""
    gen = torch.Generator().manual_seed(nl * 7 + len(lead))
    shape, hd = LEADS[lead]
    ks = ctx256.ks_tables(nl)
    x = _x(ctx256, nl, shape, gen, pad=1)
    assert not x.is_contiguous()
    rest = shape[:hd] + shape[hd + 1:]
    add = tuple(_addend(ctx256, nl, rest, gen) if a else None for a in adds)
    got = moddown.mod_down_plain(x, ctx256.ntt, ks, add, hd)
    want = _former_mod_down(ctx256, x, ks, add, hd)
    assert got.shape == shape + (nl, 256)
    assert torch.equal(got, want)


@pytest.mark.parametrize("nl", [1, 4, 12, 59])
def test_plain_matches_jax(ctx256, nl):
    """Against the JAX package's `_mod_down` and its K5 constants, on two
    leading axes (JAX is imported here alone: the card tests of this file
    run where it is absent)."""
    import jax.numpy as jnp
    from fhe_linformer_tpu.ckks import CKKSConfig as JConfig
    from fhe_linformer_tpu.ckks import Context as JContext
    from fhe_linformer_tpu.ckks import evaluator as jevm
    jks = JContext(JConfig(**SMALL)).ks_tables(nl)
    ks = ctx256.ks_tables(nl)
    u32 = lambda t: t.numpy().astype(np.uint32)
    for mine, theirs in (("pfold_s", "pfold_s"), ("pmod_s", "pmod_s"),
                         ("pinv_s", "pinv_s"), ("pinv", "pinv"),
                         ("pmod", "pmod"), ("pfold", "pfold")):
        np.testing.assert_array_equal(
            u32(getattr(ks, mine)).ravel(),
            np.asarray(getattr(jks, theirs)).ravel())
    gen = torch.Generator().manual_seed(100 + nl)
    x = _x(ctx256, nl, (2, 2), gen)
    want = np.asarray(jevm._mod_down(jnp.asarray(u32(x)), jks))
    got = moddown.mod_down_plain(x, ctx256.ntt, ks)
    np.testing.assert_array_equal(u32(got), want)


def _tie_columns(ks, n, gen, cols=48):
    """Special rows vp (2, k, n) on the CPU whose overflow sum, as the
    plain route computes it in float32, lands exactly on a tie m + 0.5 in
    a third of 2 `cols` built columns, one float32 ulp below it in a third
    and one ulp above it in the rest; the other columns are uniform.  A built column
    has small rows (below p / 32, so the sum stays below 4, where the
    float32 grid is fine) and a last row chosen for the sum.  Returns (vp,
    the built columns (half, column), their float32 sums, the ties)."""
    p = ks.q_sp.view(-1).long().cpu()
    mdq40 = ks.mdq40.cpu()
    m = mdq40.view(-1)
    k = p.shape[0]
    w = torch.randint(0, 1 << 62, (2, k, n), generator=gen) % p[:, None]
    picked, sums, ties = [], [], []
    steps = torch.arange(-4096, 4097)
    for c in range(n):
        if len(picked) == 2 * cols:
            break
        h, want = c % 2, (len(picked) // 2) % 3 - 1     # -1, 0, +1 ulp
        col = torch.randint(0, 1 << 62, (k,), generator=gen) % (p // 32)
        rest = int((col[:-1] * m[:-1]).sum())
        tie = math.ceil(rest / 2 ** 40 - 0.5) + 0.5     # in [E_rest, +1)
        cand = round((tie * 2 ** 40 - rest) / int(m[-1])) + steps
        cand = cand[(cand >= 0) & (cand < int(p[-1]))]
        trial = col[:, None].repeat(1, cand.numel())
        trial[-1] = cand
        al, ahbb = moddown.md_partials(trial.int(), mdq40)
        s = (al.float() * (2.0 ** -40) + ahbb.float() * (2.0 ** -24))[0]
        t32 = torch.tensor(tie, dtype=torch.float32)
        target = torch.nextafter(t32, t32 + want) if want else t32
        hit = (s == target).nonzero().view(-1)
        if hit.numel() == 0:
            continue
        col[-1] = cand[hit[0]]
        w[h, :, c] = col
        picked.append((h, c))
        sums.append(float(s[hit[0]]))
        ties.append(tie)
    assert len(picked) == 2 * cols, len(picked)
    inv = torch.tensor([pow(int(f), -1, int(q)) for f, q in
                        zip(ks.pfold.view(-1).cpu(), p)]).view(-1, 1)
    return (w * inv % p[:, None]).int(), picked, sums, ties


def test_tie_columns(ctx256):
    """The plain fold returns the built columns' w, and their overflow
    rounds half to even on the tie and to the nearer integer beside it."""
    ks = ctx256.ks_tables(12)
    gen = torch.Generator().manual_seed(9)
    vp, picked, sums, ties = _tie_columns(ks, 256, gen, cols=12)
    w, v = moddown.md_fold_plain(vp, ks)
    assert torch.equal(w, mulmod(vp, ks.pfold, ks.q_sp))
    for (h, c), s, t in zip(picked, sums, ties):
        got = int(v[h, 0, c])
        if s == t:
            assert got == int(np.rint(t)) and got % 2 == 0
        else:
            assert got == (int(np.ceil(t)) if s > t else int(np.floor(t)))


# what the wrapper must refuse, and the words of its message
BAD = {"dtype": "x must be torch.int32", "rows": "x must be",
       "coefficient stride": "x: rows must be contiguous",
       "out over specials": "out overlaps x", "out over x": "out overlaps x",
       "halves axis": "must hold the two key halves",
       "addend shape": "add0 must be", "addend dtype": "add1 must be",
       "out shape": "out must be", "misaligned": "aligned"}


def _bad_call(what, ctx, ks, gen):
    nl, n = ks.nl, ctx.cfg.n
    x = _x(ctx, nl, (2, 3), gen)
    call = dict(x=x, ks=ks)
    if what == "dtype":
        call["x"] = x.long()
    elif what == "rows":
        call["x"] = x[..., 1:, :]
    elif what == "coefficient stride":
        call["x"] = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif what == "out over specials":     # K2 has read them, K5 would write
        call["out"] = x[..., K_SP:, :]
    elif what == "out over x":
        call["out"] = x[..., :nl, :]
    elif what == "halves axis":
        call["half_dim"] = 1
    elif what == "addend shape":
        call["add"] = (_addend(ctx, nl, (2, 3), gen), None)
    elif what == "addend dtype":
        call["add"] = (None, _addend(ctx, nl, (3,), gen).long())
    elif what == "out shape":
        call["out"] = torch.empty((2, 3, nl + 1, n), dtype=torch.int32)
    elif what == "misaligned":              # one word past an aligned buffer
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        call["x"] = buf[1:].view(x.shape).copy_(x)
    return call


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrapper_refuses(ctx256, what):
    ks = ctx256.ks_tables(24)          # nl > k: the specials overlap Q rows
    gen = torch.Generator().manual_seed(3)
    with pytest.raises((TypeError, ValueError), match=BAD[what]):
        moddown.finish_args(**_bad_call(what, ctx256, ks, gen))


def test_finish_args_takes_out_and_addends(ctx256):
    """A strided `out` (one group of a larger buffer) and addends are
    taken; the batch splits as (outer, halves, inner)."""
    ks = ctx256.ks_tables(4)
    gen = torch.Generator().manual_seed(4)
    x = _x(ctx256, 4, (3, 2, 5), gen, pad=1)
    buf = torch.empty((2, 3, 2, 5, 4, 256), dtype=torch.int32)
    add = (_addend(ctx256, 4, (3, 5), gen), None)
    x_es, out, out_es, adds, add_es, inner, batch = moddown.finish_args(
        x, ks, add, 1, buf[1])
    assert (x_es, out_es, add_es, inner, batch) == \
        ((4 + K_SP + 2) * 256, 4 * 256, [4 * 256, 0], 5, 30)
    assert out.data_ptr() == buf[1].data_ptr() and adds[1] is None


def test_counts(ctx256):
    """A CPU mod-down counts one call and launches nothing; the evaluator
    runs one mod-down per key switch: a rotation, a hoisted rotation of 2
    shifts (one batched mod-down), a product and a rotation combo."""
    ks = ctx256.ks_tables(3)
    gen = torch.Generator().manual_seed(5)
    calls, launched = GLOBAL_TIMERS.counts["mod_down"], dict(KERNEL_LAUNCHES)
    moddown.mod_down(_x(ctx256, 3, (2,), gen), ctx256.ntt, ks)
    assert GLOBAL_TIMERS.counts["mod_down"] == calls + 1
    assert KERNEL_LAUNCHES == launched
    cfg = CKKSConfig(n=256, scale_bits=26, num_scaling=6, dnum=2, seed=8)
    ctx = Context(cfg, device="cpu")
    ev = Evaluator(ctx, generate_keys(ctx, rotations=(1, 2, 3)))
    ct = ev.encrypt(np.random.default_rng(6).uniform(-1, 1, cfg.slots))
    rng = np.random.default_rng(7)
    items = [(r, ev.encode_coeff_cached(("md", r), rng.uniform(
        -1, 1, cfg.slots))) for r in (1, 2, 3)]
    before = GLOBAL_TIMERS.counts["mod_down"]
    ev.rotate(ct, 1)
    ev.rotate_hoisted(ct, [1, 2])
    ev.mul(ct, ct)
    ev.rotate_combo(ct, items)
    assert GLOBAL_TIMERS.counts["mod_down"] - before == 4


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture(scope="module")
def cells():
    """The cells' chain at n = 2^15 (tables only), on the card."""
    if not torch.cuda.is_available():
        return None
    return Context(get("linformer-boot-w").ckks, device="cuda")


def _cuda_x(ctx, nl, lead, seed, pad=0):
    gen = torch.Generator().manual_seed(seed)
    return _x(ctx, nl, lead, gen, pad)


def _entries_case(ctx, nl, lead, seed):
    """Each entry point against its plain version on the same inputs."""
    ks = ctx.ks_tables(nl)
    x = _cuda_x(ctx, nl, lead, seed)
    vp = ntt.inv(x[..., nl:, :], ctx.ntt, ks.sp_idx)
    w, v = moddown.md_fold(vp, ks)
    w0, v0 = moddown.md_fold_plain(vp, ks)
    y = base_convert(w0, ks.md, prefolded=True)[0]
    y0 = moddown.md_lift_plain(y, v0, ks)
    y1 = moddown.md_lift(y.clone(), v0, ks)
    y_e = ntt.fwd(y0, ctx.ntt, ks.act_idx)
    gen = torch.Generator().manual_seed(seed + 1)
    add = (_addend(ctx, nl, lead[1:], gen), None)
    got = moddown.md_finish(x, y_e, ks, add)
    want = moddown.md_finish_plain(x, y_e, ks, add)
    torch.cuda.synchronize()
    assert torch.equal(w, w0) and torch.equal(v, v0), (nl, lead, "fold")
    assert torch.equal(y1, y0), (nl, lead, "lift")
    assert torch.equal(got, want), (nl, lead, "finish")


@pytest.mark.card
@pytest.mark.parametrize("lead", [(2, 1), (2, 8), (2, 32)],
                         ids=["b1", "b8", "b32"])
@pytest.mark.parametrize("nl", [7, 12, 22, 45, 59])
def test_card_entries(card, cells, nl, lead):
    _entries_case(cells, nl, lead, nl + lead[1])


def _whole_case(ctx, nl, lead, hd, adds, seed, pad=1, out=False):
    ks = ctx.ks_tables(nl)
    x = _cuda_x(ctx, nl, lead, seed, pad)
    gen = torch.Generator().manual_seed(seed + 1)
    rest = lead[:hd] + lead[hd + 1:]
    add = tuple(_addend(ctx, nl, rest, gen) if a else None for a in adds)
    buf = torch.zeros((3,) + lead + (nl, ctx.cfg.n), dtype=torch.int32,
                      device="cuda") if out else None
    calls, fin = GLOBAL_TIMERS.counts["mod_down"], KERNEL_LAUNCHES["md_finish"]
    got = moddown.mod_down(x, ctx.ntt, ks, add, hd,
                           buf[1] if out else None)
    assert GLOBAL_TIMERS.counts["mod_down"] - calls == \
        KERNEL_LAUNCHES["md_finish"] - fin == 1
    want = moddown.mod_down_plain(x, ctx.ntt, ks, add, hd)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (nl, lead, hd, adds)
    if out:
        assert got.data_ptr() == buf[1].data_ptr()
        assert not buf[0].any() and not buf[2].any()


@pytest.mark.card
@pytest.mark.parametrize("adds", [(False, False), (True, False),
                                  (True, True)], ids=["none", "c0", "d0d1"])
@pytest.mark.parametrize("nl, lead, hd", [
    (22, (2, 8), 0),            # the per-token FFN's batch-8 switches
    (12, (2, 2), 0),            # a Galois switch of 2 cts, the input level
    (59, (2, 1), 0),            # the bootstrap's top level
    (45, (2, 8, 2), 0),         # EvalMod's pairs
    (10, (16, 2, 1), 1),        # a combo's 16 groups, halves on axis 1
    (30, (4, 2, 8), 1)],        # 4 groups of a batch of 8
    ids=["pertoken", "galois", "top", "evalmod", "combo16", "combo4x8"])
def test_card_mod_down(card, cells, nl, lead, hd, adds):
    _whole_case(cells, nl, lead, hd, adds, nl)


@pytest.mark.card
def test_card_mod_down_out(card, cells):
    _whole_case(cells, 22, (2, 8), 0, (True, True), 3, out=True)


@pytest.mark.card
@pytest.mark.parametrize("nl", [12, 59])
def test_card_ties(card, cells, nl):
    """md_fold on columns built to land on a float32 tie of the overflow
    sum and one ulp either side of it, among uniform columns."""
    ks = cells.ks_tables(nl)
    gen = torch.Generator().manual_seed(nl)
    vp, picked, _, _ = _tie_columns(ks, cells.cfg.n, gen)
    vp = vp.cuda()
    w, v = moddown.md_fold(vp, ks)
    w0, v0 = moddown.md_fold_plain(vp, ks)
    torch.cuda.synchronize()
    assert torch.equal(w, w0) and torch.equal(v, v0)
    assert len(picked) == 96


@pytest.mark.card
@pytest.mark.parametrize("preset", ["linformer-128c", "tiny"],
                         ids=["ring16", "ring8"])
def test_card_other_rings(card, preset):
    """Ring 2^16 (47 limbs) and preset tiny's ring 2^8 (8 specials)."""
    ctx = Context(get(preset).ckks, device="cuda")
    _entries_case(ctx, 22, (2, 4), 11)
    _whole_case(ctx, 22, (3, 2, 4), 1, (True, False), 12)


@pytest.mark.card
@pytest.mark.parametrize("what", sorted(BAD))
def test_card_wrapper_refuses(card, cells, what):
    ks = cells.ks_tables(24)
    gen = torch.Generator().manual_seed(3)
    call = _bad_call(what, cells, ks, gen)
    before = dict(KERNEL_LAUNCHES)
    with pytest.raises((TypeError, ValueError), match=BAD[what]):
        moddown.mod_down_cuda(t=cells.ntt, **call)
    assert KERNEL_LAUNCHES == before             # refused before K2 ran


@pytest.mark.card
def test_card_evaluator(card):
    """The evaluator's key-switching ops at preset tiny's shapes (n = 2^8,
    dnum 8) on the card equal the same ops on the CPU; each mod-down
    launched md_finish once."""
    cfg = get("tiny").ckks
    evs = []
    for device in ("cuda", "cpu"):
        ctx = Context(cfg, device=device)
        evs.append(Evaluator(ctx, generate_keys(ctx, rotations=(1, 2, 3))))
    cpu = evs[1]
    c = cpu.encrypt(np.random.default_rng(3).uniform(-1, 1, (2, cfg.n // 2)),
                    batch=True)
    cts = [Ciphertext(c.c0.cuda(), c.c1.cuda(), c.nl, c.scale), c]
    outs = []
    for ev, ct in zip(evs, cts):
        rng = np.random.default_rng(4)
        items = [(r, ev.encode_coeff_cached(("md", r), rng.uniform(
            -1, 1, cfg.n // 2))) for r in (1, 2, 3)]
        calls = GLOBAL_TIMERS.counts["mod_down"]
        fin = KERNEL_LAUNCHES["md_finish"]
        outs.append([ev.rotate(ct, 1), ev.mul(ct, ct),
                     *ev.rotate_hoisted(ct, [1, 2, 3]).values(),
                     ev.rotate_combo(ct, items)])
        if ev is evs[0]:
            torch.cuda.synchronize()
            assert GLOBAL_TIMERS.counts["mod_down"] - calls == \
                KERNEL_LAUNCHES["md_finish"] - fin == 4
    for got, want in zip(*outs):
        assert torch.equal(got.c0.cpu(), want.c0)
        assert torch.equal(got.c1.cpu(), want.c1)
