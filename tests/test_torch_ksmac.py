"""K4 `ks_mac`, the key switch's modular multiply-accumulate
(`ops/ksmac.py`, `csrc/ksmac.cu`).

On the CPU: the plain version equals, bit for bit, the evaluator's former
inline expressions it replaced (the key inner products `_inner_ext`, with
and without a Galois gather, full-basis and reduced-basis keys, batches of
1 and 8; the rotation combo's plaintext sums, with sel over 16 and 32
rows, past the kernel's 8-product reduction); the wrapper's checks refuse
what the kernel does not take; the evaluator calls it once per inner
product.

Tests marked `card` need a CUDA card and skip without one.  They hold the
kernel bit for bit against the plain version at the benchmark cells'
shapes (n = 2^15, 3 digits, levels 7, 12, 22 and 59 with 20 specials,
batches 1 and 8, with and without a gather), at n = 2^16 and at n = 2^8
with 8 digits, and run an evaluator at preset `tiny` on the card against
the same ops on the CPU.  On the card's machine, which has no JAX:
`python3 -m pytest --noconftest -p no:cacheprovider
tests/test_torch_ksmac.py -m card`.
"""

import numpy as np
import pytest
import torch

from fhe_linformer_tpu_torch.ckks.ciphertext import Ciphertext
from fhe_linformer_tpu_torch.ckks.context import Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import KSKey, generate_keys
from fhe_linformer_tpu_torch.config import get
from fhe_linformer_tpu_torch.ops import ksmac
from fhe_linformer_tpu_torch.primes import ntt_primes
from fhe_linformer_tpu_torch.utils.timing import (GLOBAL_TIMERS,
                                                  KERNEL_LAUNCHES)

K_SP = 20                   # the cells' special primes


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _residues(shape, qs, gen, device="cpu"):
    """Uniform residues below each row's prime (rows on axis -2)."""
    q = torch.tensor(qs, dtype=torch.int64).view(-1, 1)
    x = torch.randint(0, 1 << 62, shape, generator=gen)
    return (x % q).int().to(device)


def _former_inner_ext(y_e, key, nl, sp, q_act, q_sp):
    """The evaluator's `_inner_ext` before K4, unchanged."""
    nd = y_e.shape[0]
    bshape = (nd,) + (1,) * (y_e.dim() - 3)
    out = []
    for half in (key.b, key.a):
        parts = []
        for y, k, q in ((y_e[..., :nl, :], half[:nd, :nl], q_act),
                        (y_e[..., nl:, :], half[:nd, sp:], q_sp)):
            k = k.reshape(bshape + k.shape[1:])
            prod = torch.remainder(y.long() * k, q)
            parts.append(torch.remainder(prod.sum(0), q).int())
        out.append(torch.cat(parts, -2))
    return out[0], out[1]


def _former_wsum(rows, idx, pt, q):
    """The evaluator's `_stage2_sums.wsum` before K4, unchanged."""
    pt = pt.view((len(idx),) + (1,) * (rows.dim() - 3) + pt.shape[1:])
    sel = torch.tensor(idx, device=rows.device)
    prod = torch.remainder(rows.index_select(0, sel).long() * pt, q)
    return torch.remainder(prod.sum(0), q).int()


def _case(n, nl, nd, lead, max_nl=None, num_q=None, seed=0,
          device="cpu"):
    """Digits y_e (nd, *lead, nl + K_SP, n) and a key of nd + 1 digits over
    num_q q-limbs and the specials (reduced: max_nl q-limbs)."""
    gen = torch.Generator().manual_seed(seed)
    num_q = num_q or nl + 3
    qs = ntt_primes(2 * n, num_q + K_SP)
    sp = num_q if max_nl is None else max_nl
    key_qs = qs[:sp] + qs[num_q:]
    key = KSKey(*(_residues((nd + 1, len(key_qs), n), key_qs, gen, device)
                  for _ in range(2)), max_nl=max_nl)
    tgt = qs[:nl] + qs[num_q:]
    y_e = _residues((nd,) + lead + (len(tgt), n), tgt, gen, device)
    q = torch.tensor(tgt, dtype=torch.int32).view(-1, 1).to(device)
    perm = torch.from_numpy(
        ((5 * (2 * np.arange(n) + 1)) % (2 * n) - 1) // 2).to(device)
    return y_e, key, sp, q, perm


@pytest.mark.parametrize("lead", [(), (1,), (8,)], ids=["single", "b1", "b8"])
@pytest.mark.parametrize("gather", [False, True], ids=["plain", "galois"])
@pytest.mark.parametrize("max_nl", [None, 7], ids=["full", "reduced"])
def test_inner_products_match_former(lead, gather, max_nl):
    nl = 5
    y_e, key, sp, q, perm = _case(64, nl, 3, lead, max_nl=max_nl, num_q=9)
    p = perm if gather else None
    got = ksmac.ks_mac_plain(y_e, (key.b, key.a), q, split=nl,
                             w_off=sp - nl, perm=p)
    want = _former_inner_ext(y_e if p is None else y_e.index_select(-1, p),
                             key, nl, sp, q[:nl], q[nl:])
    assert got.shape == (2,) + lead + (nl + K_SP, 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("J", [16, 32])
def test_plaintext_sums_match_former(J):
    """sel picks J of 40 stage-1 rows out of order; the c0 sum reads the
    plaintexts' first nl rows, the key halves' sums all nl + K_SP."""
    n, nl, S = 64, 6, 40
    gen = torch.Generator().manual_seed(J)
    qs = ntt_primes(2 * n, nl + K_SP)
    q = torch.tensor(qs, dtype=torch.int32).view(-1, 1)
    idx = torch.randperm(S, generator=gen)[:J].tolist()
    pt = _residues((J, nl + K_SP, n), qs, gen)
    t01 = _residues((S, 2, 3, nl + K_SP, n), qs, gen)
    c0ps = _residues((S, 3, nl, n), qs[:nl], gen)
    got = ksmac.ks_mac_plain(t01, (pt,), q, sel=idx)
    assert got.shape == (1, 2, 3, nl + K_SP, n)
    for h in range(2):
        assert torch.equal(got[0, h], _former_wsum(t01[:, h], idx, pt, q))
    got0 = ksmac.ks_mac_plain(c0ps, (pt,), q[:nl], sel=idx)[0]
    assert torch.equal(got0, _former_wsum(c0ps, idx, pt[:, :nl], q[:nl]))


def test_out_and_counts():
    """`out` may be a strided slice (one entry of a stacked batch); a CPU
    call counts as an inner product and launches nothing."""
    y_e, key, sp, q, _ = _case(64, 4, 3, (2,))
    acc = torch.zeros((2, 3, 2, 4 + K_SP, 64), dtype=torch.int32)
    calls, launched = GLOBAL_TIMERS.counts["ks_mac"], dict(KERNEL_LAUNCHES)
    ksmac.ks_mac(y_e, (key.b, key.a), q, split=4, w_off=sp - 4,
                 out=acc[:, 1])
    assert GLOBAL_TIMERS.counts["ks_mac"] == calls + 1
    assert KERNEL_LAUNCHES == launched
    want = _former_inner_ext(y_e, key, 4, sp, q[:4], q[4:])
    assert torch.equal(acc[0, 1], want[0]) and torch.equal(acc[1, 1], want[1])
    assert not acc[:, 0].any() and not acc[:, 2].any()


# what the wrapper must refuse, and the words of its message
BAD = {"dtype": "a must be torch.int32", "key dtype": "w0 must be",
       "perm dtype": "perm must be torch.int64",
       "non-contiguous": "a's entries must be contiguous",
       "short key": "cannot serve", "few digits": "cannot serve",
       "moduli": "q must be", "perm length": "perm must be",
       "sel range": "outside a's", "three halves": "1 or 2 weight",
       "out shape": "out must be", "misaligned": "aligned"}


def _bad_call(what, y_e, key, sp, q, perm, nl=4):
    w = (key.b, key.a)
    call = dict(a=y_e, w=w, q=q, split=nl, w_off=sp - nl)
    if what == "dtype":
        call["a"] = y_e.long()
    elif what == "key dtype":
        call["w"] = (key.b.long(), key.a)
    elif what == "perm dtype":
        call["perm"] = perm.int()
    elif what == "non-contiguous":
        call["a"] = y_e.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "short key":
        call["w"] = (key.b[:, :nl], key.a[:, :nl])
    elif what == "few digits":
        call["w"] = (key.b[:2], key.a[:2])
    elif what == "moduli":
        call["q"] = q[:nl]
    elif what == "perm length":
        call["perm"] = perm[:8]
    elif what == "sel range":
        call["sel"] = [0, 5]
    elif what == "three halves":
        call["w"] = w + (key.a,)
    elif what == "out shape":
        call["out"] = torch.empty_like(y_e)
    elif what == "misaligned":         # one word past an aligned buffer
        buf = torch.empty(y_e.numel() + 1, dtype=y_e.dtype,
                          device=y_e.device)
        call["a"] = buf[1:].view(y_e.shape).copy_(y_e)
    return call


@pytest.mark.parametrize("what", sorted(BAD))
def test_wrapper_refuses(what):
    y_e, key, sp, q, perm = _case(64, 4, 3, (2,))
    with pytest.raises((TypeError, ValueError), match=BAD[what]):
        ksmac.launch_args(**_bad_call(what, y_e, key, sp, q, perm))


def test_evaluator_counts_inner_products():
    """A rotation, a hoisted rotation of 2 shifts, a product and a rotation
    combo of 3 baby shifts: 1 + 2 + 1 + (3 + 2) inner products."""
    ev, ct = _tiny_evaluator("cpu")
    items = _combo_items(ev)
    before = GLOBAL_TIMERS.counts["ks_mac"]
    ev.rotate(ct, 1)
    ev.rotate_hoisted(ct, [1, 2])
    ev.mul(ct, ct)
    ev.rotate_combo(ct, items)
    assert GLOBAL_TIMERS.counts["ks_mac"] - before == 9


# ---------------------------------------------------------------------------
# on the card

def _tiny_evaluator(device):
    """Preset tiny's chain (n = 2^8, 59 limbs, dnum 8) with rotation keys
    1-3, and a batch of 2 ciphertexts encrypted on the CPU."""
    cfg = get("tiny").ckks
    ctx = Context(cfg, device=device)
    ev = Evaluator(ctx, generate_keys(ctx, rotations=(1, 2, 3), conj=True))
    cpu = Evaluator(Context(cfg, device="cpu"),
                    generate_keys(Context(cfg, device="cpu")))
    z = np.random.default_rng(3).uniform(-1, 1, (2, cfg.n // 2))
    c = cpu.encrypt(z, batch=True)
    return ev, Ciphertext(c.c0.to(device), c.c1.to(device), c.nl, c.scale)


def _combo_items(ev):
    rng = np.random.default_rng(4)
    return [(r, ev.encode_coeff_cached(("ksmac", r), rng.uniform(
        -1, 1, ev.ctx.cfg.n // 2))) for r in (1, 2, 3)]


def _card_case(n, nl, nd, B, gather, max_nl=None, num_q=59):
    y_e, key, sp, q, perm = _case(n, nl, nd, (B,), max_nl=max_nl,
                                  num_q=num_q, seed=nl + B, device="cuda")
    kw = dict(split=nl, w_off=sp - nl, perm=perm if gather else None)
    got = ksmac.ks_mac_cuda(y_e, (key.b, key.a), q, **kw)
    want = ksmac.ks_mac_plain(y_e, (key.b, key.a), q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (n, nl, nd, B, gather, max_nl)


@pytest.mark.card
@pytest.mark.parametrize("gather", [False, True], ids=["plain", "galois"])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("nl", [7, 12, 22, 59])
def test_card_cells_shapes(card, nl, B, gather):
    _card_case(1 << 15, nl, 3, B, gather)


@pytest.mark.card
@pytest.mark.parametrize("n, nl, nd, B, max_nl, num_q", [
    (1 << 15, 22, 3, 8, 36, 59),        # reduced-basis key
    (1 << 16, 22, 3, 2, None, 47),      # ring 2^16
    (1 << 8, 59, 8, 8, None, 59),       # preset tiny: dnum 8
    (1 << 8, 5, 1, 1, None, 59)],       # one digit, one ciphertext
    ids=["reduced", "ring16", "tiny", "one-digit"])
@pytest.mark.parametrize("gather", [False, True], ids=["plain", "galois"])
def test_card_other_shapes(card, n, nl, nd, B, max_nl, num_q, gather):
    _card_case(n, nl, nd, B, gather, max_nl=max_nl, num_q=num_q)


@pytest.mark.card
@pytest.mark.parametrize("J", [1, 16, 32, 64])
def test_card_plaintext_sums(card, J):
    n, nl, S = 1 << 15, 22, 64
    gen = torch.Generator().manual_seed(J)
    qs = ntt_primes(2 * n, nl + K_SP)
    q = torch.tensor(qs, dtype=torch.int32).view(-1, 1).cuda()
    idx = torch.randperm(S, generator=gen)[:J].tolist()
    pt = _residues((J, nl + K_SP, n), qs, gen, "cuda")
    t01 = _residues((S, 2, 2, nl + K_SP, n), qs, gen, "cuda")
    c0ps = _residues((S, 2, nl, n), qs[:nl], gen, "cuda")
    out = torch.zeros((3, 2, 2, nl + K_SP, n), dtype=torch.int32,
                      device="cuda")
    ksmac.ks_mac_cuda(t01, (pt,), q, sel=idx, out=out[1][None])
    want = ksmac.ks_mac_plain(t01, (pt,), q, sel=idx)
    got0 = ksmac.ks_mac_cuda(c0ps, (pt,), q[:nl], sel=idx)
    want0 = ksmac.ks_mac_plain(c0ps, (pt,), q[:nl], sel=idx)
    torch.cuda.synchronize()
    assert torch.equal(out[1], want[0]) and torch.equal(got0, want0)
    assert not out[0].any() and not out[2].any()


@pytest.mark.card
@pytest.mark.parametrize("what", sorted(BAD))
def test_card_wrapper_refuses(card, what):
    y_e, key, sp, q, perm = _case(64, 4, 3, (2,), device="cuda")
    with pytest.raises((TypeError, ValueError), match=BAD[what]):
        ksmac.ks_mac_cuda(**_bad_call(what, y_e, key, sp, q, perm))


@pytest.mark.card
def test_card_evaluator(card):
    """The evaluator's key-switching ops at preset tiny's shapes (n = 2^8,
    dnum 8) on the card equal the same ops on the CPU; every inner product
    launched K4 once."""
    ev, ct = _tiny_evaluator("cuda")
    ref, rct = _tiny_evaluator("cpu")
    calls, launches = GLOBAL_TIMERS.counts["ks_mac"], KERNEL_LAUNCHES["ks_mac"]
    outs = [ev.rotate(ct, 1), ev.mul(ct, ct), ev.conjugate(ct),
            *ev.rotate_hoisted(ct, [1, 2, 3]).values(),
            ev.rotate_combo(ct, _combo_items(ev))]
    torch.cuda.synchronize()
    assert GLOBAL_TIMERS.counts["ks_mac"] - calls == \
        KERNEL_LAUNCHES["ks_mac"] - launches == 11
    wants = [ref.rotate(rct, 1), ref.mul(rct, rct), ref.conjugate(rct),
             *ref.rotate_hoisted(rct, [1, 2, 3]).values(),
             ref.rotate_combo(rct, _combo_items(ref))]
    for got, want in zip(outs, wants):
        assert torch.equal(got.c0.cpu(), want.c0)
        assert torch.equal(got.c1.cpu(), want.c1)
