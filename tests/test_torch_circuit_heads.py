"""The port's block-major circuit with several heads and a model wider
than one lane block, on the CPU at the tiny ring of
tests/test_torch_circuit_packed.py (n = 256, block width 8, nb = 16
tokens per ciphertext), keys from the port's own key generation:

  * a 2-block model (d_model 16, 4 heads of 4, two to a block, k_lin 8,
    d_ffn 64, S = 20 in 2 chunks), with and without the test bootstrap:
    logits against the benchmark's plain multi-head reference and against
    golden.forward(heads=4), at tolerances that a wrong head split,
    swapped head masks or uniform attention would exceed
  * heads = 1 and one block: every stage's ciphertext bit for bit what the
    circuit computed before it took heads and blocks (digests frozen from
    that code on this test's keys and inputs)
  * the block-grid matmul against the plain product
  * the `block_matmul` and `pt_rows` counters
  * the encoder's batched transform (the grid's diagonals) against
    encode(), to the bit, a coefficient at a rounding tie included
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.encoding import Encoder
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.linalg.blockmat import BlockOps
from fhe_linformer_tpu_torch.models import golden
from fhe_linformer_tpu_torch.models.circuit import CircuitParams
from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer
from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS
from port_bench.harness import BENCH, load_module

PARAMS = dict(n=256, scale_bits=26, num_scaling=58, dnum=4, seed=99)
BOOT_PARAMS = dict(n=256, scale_bits=26, num_scaling=34, dnum=4, seed=23,
                   secret_hw=8)
BOOT = dict(level_budget=(2, 2), K=8, sin_degree=59, double_angles=1)
BLOCK, BS = 8, 4
D, HEADS, KLIN, FFN, NCLS = 16, 4, 8, 64, 5
S = 20
# Gains on the drawn Q/K and V/O weights (and biases): at the draw's scale
# the scores are about 3e-3, the softmax is uniform and no head's
# attention moves the logits.  With these the scores reach 0.6-1.1 (std
# 0.14-0.17), inside the degree-6 Taylor's range, and a planted attention
# fault moves the logits by 7e-4 or more (test_head_faults_...).
QK_GAIN, VO_GAIN = 8.0, 3.0
# |logit - reference| allowed: the circuit's gap on this test's inputs is
# 6.7e-6 (plain: CKKS noise at n = 256 and the degree-27 inverse, GELU and
# tanh) and 4.5e-5 (bootstrapped, degree 13); 15x and 6.7x that
TOL = {"plain": 1e-4, "boot": 3e-4}


def _rotations(slots, extra=()):
    rots, s = {3}, 1                    # the one non-pow2 baby under BS
    while s < slots:
        rots |= {s, -s}
        s *= 2
    return tuple(sorted(rots | set(extra)))


def _ev(params, boot=None):
    torch.set_num_threads(2)
    ctx = Context(CKKSConfig(**params), device="cpu")
    extra = Bootstrapper.rotations_for(params["n"], BootConfig(**boot)) \
        if boot else ()
    return Evaluator(ctx, generate_keys(ctx, rotations=_rotations(
        ctx.cfg.slots, extra), conj=boot is not None))


@pytest.fixture(scope="module")
def ev():
    return _ev(PARAMS)


@pytest.fixture(scope="module")
def boot_ev():
    return _ev(BOOT_PARAMS, BOOT)


def _ref():
    return load_module(BENCH / "reference" / "linformer_heads.py")


def _model(max_seq):
    w = golden.random_weights(d=D, k_lin=KLIN, d_ffn=FFN, n_classes=NCLS,
                              max_seq=max_seq, seed=5, scale=0.35)
    gains = dict.fromkeys(("WQ", "BQ", "WK", "BK"), QK_GAIN) | \
        dict.fromkeys(("WV", "BV", "WO", "BO"), VO_GAIN)
    return dataclasses.replace(w, **{k: getattr(w, k) * g
                                     for k, g in gains.items()})


def _inputs(mode):
    boot = mode == "boot"
    return _model(24 if boot else 40), \
        np.random.default_rng(17).normal(0, 0.3, (S - 1, D))


def _params(w, emb, degree):
    """Intervals from the multi-head golden model's intermediates, as the
    packed tests calibrate (every head's row sums)."""
    _, inter = golden.forward(w, emb, return_intermediates=True,
                              heads=HEADS)
    rowsum = inter["exp"].sum(-1)
    h_in = inter["norm1"] @ w.W1.T + w.B1[None]
    p_in = inter["norm2"][:1] @ w.Wp.T + w.bp[None]
    return CircuitParams(
        inv_range=(0.8 * rowsum.min(), 1.25 * rowsum.max()),
        inv_degree=degree, gelu_clip=1.0 / (1.15 * np.abs(h_in).max()),
        gelu_degree=degree, tanh_scale=1.0 / (1.15 * np.abs(p_in).max()),
        tanh_degree=degree, exp_pow8=False)


@pytest.mark.parametrize("mode", ["plain", "boot"])
def test_heads_forward_matches_references(ev, boot_ev, mode):
    """The 2-block, 4-head forward's logits against the plain reference
    (float64 torch, exact exp/GELU/tanh/division) and golden(heads=4),
    within TOL: the circuit's approximations, the degree-27 (13 with the
    bootstrap) Chebyshev inverse, GELU and tanh, and CKKS noise at
    n = 256."""
    boot = mode == "boot"
    e = boot_ev if boot else ev
    w, emb = _inputs(mode)
    circ = PackedLinformer(e, w, _params(w, emb, 13 if boot else 27),
                           bs=BS, heads=HEADS, block=BLOCK)
    booter = Bootstrapper(e, BootConfig(**BOOT)) if boot else None
    before = GLOBAL_TIMERS.counts["bootstrap"]
    logits = circ.decrypt_logits(circ.forward(
        emb, boot=booter, input_nl=12 if boot else None))
    if boot:
        assert GLOBAL_TIMERS.counts["bootstrap"] - before >= 3
    gold = golden.forward(w, emb, return_intermediates=True,
                          heads=HEADS)[1]["logits"]
    wt = {k: torch.as_tensor(np.asarray(v, np.float64))
          for k, v in vars(w).items()}
    ref, _ = _ref().forward(wt, torch.as_tensor(emb), heads=HEADS)
    np.testing.assert_allclose(ref.numpy(), gold, atol=1e-12)
    assert np.all(np.isfinite(logits)), logits
    assert np.argmax(logits) == np.argmax(gold), (logits, gold)
    np.testing.assert_allclose(logits, ref.numpy(), rtol=0, atol=TOL[mode])


def _head_roll(v, shift=1):
    """v's head blocks of D / HEADS features (rows) rolled by `shift`."""
    hd = D // HEADS
    return np.roll(np.asarray(v), -shift * hd, axis=0)


@pytest.mark.parametrize("mode", ["plain", "boot"])
def test_head_faults_move_logits_past_tolerance(mode):
    """Each planted attention fault moves golden's logits by more than
    twice TOL from golden(heads=4), so a circuit that computed it would
    fail test_heads_forward_matches_references: one head over all 16
    features, one head per 8-lane block (two heads' scores summed), each
    head's scores from the next head's features (swapped head masks), and
    uniform attention (zero scores)."""
    w, emb = _inputs(mode)

    def logits(w, heads=HEADS):
        return golden.forward(w, emb, return_intermediates=True,
                              heads=heads)[1]["logits"]
    want = logits(w)
    faults = {
        "one head": logits(w, 1),
        "a head per block": logits(w, D // BLOCK),
        "swapped head masks": logits(dataclasses.replace(w, **{
            k: _head_roll(getattr(w, k)) for k in ("WQ", "BQ", "WK",
                                                   "BK")})),
        "uniform attention": logits(dataclasses.replace(
            w, WQ=0 * w.WQ, BQ=0 * w.BQ)),
    }
    gaps = {k: float(np.abs(v - want).max()) for k, v in faults.items()}
    assert min(gaps.values()) > 2 * TOL[mode], gaps


# sha256 prefixes of (c0, c1) bytes with (nl, scale) of: x, XE, the
# attention, affine 1, the FFN and the pooler/classifier output, from the
# one-head one-block circuit as it was before heads and blocks (S = 20,
# d 8, k_lin 4, d_ffn 32, bs 4; plain: the chain whole, degree 27;
# bootstrapped: inputs at 12 limbs, degree 13)
FROZEN = {
    "plain": [("bb77e6ec03ca26a8", 59, 67108864.0),
              ("eceb021016c98c63", 59, 67108864.0),
              ("eb6f26f950344135", 36, 69322892.38214706),
              ("0e50e6f4e4773df9", 35, 69224129.50814345),
              ("48c115821fc7a3b8", 25, 66611210.91266737),
              ("4ed5ba346f722467", 12, 60374390.33307403)],
    "boot": [("768c2e1345f41b76", 12, 67108864.0),
             ("3a55569a99f567db", 12, 67108864.0),
             ("838549692895ea57", 3, 106254088.15034366),
             ("6bce5136cafd33d4", 2, 106260572.19756503),
             ("122b436b271b6ebe", 8, 67041855.59005602),
             ("a4d34ee97c71938d", 5, 67202658.05279875)],
}


def _digest(ct):
    h = hashlib.sha256()
    for t in (ct.c0, ct.c1):
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16], ct.nl, ct.scale


@pytest.mark.parametrize("mode", ["plain", "boot"])
def test_one_head_one_block_is_unchanged(ev, boot_ev, mode):
    """On a fresh evaluator of the same keys: its encryptions draw from a
    generator of their own."""
    boot = mode == "boot"
    e = boot_ev if boot else ev
    e = Evaluator(e.ctx, e.keys)
    w = golden.random_weights(d=8, k_lin=4, d_ffn=32, n_classes=5,
                              max_seq=24 if boot else 40, seed=5, scale=0.35)
    emb = np.random.default_rng(17).normal(0, 0.3, (S - 1, 8))
    deg = 13 if boot else 27
    circ = PackedLinformer(e, w, CircuitParams(
        inv_range=(0.5, 20.0), inv_degree=deg, gelu_clip=0.3,
        gelu_degree=deg, tanh_scale=0.3, tanh_degree=deg), bs=BS)
    booter = Bootstrapper(e, BootConfig(**BOOT)) if boot else None
    x, xe, xf, St = circ.encrypt_inputs(emb, nl=12 if boot else None)
    got = [_digest(x), _digest(xe)]
    a = circ.attention(x, xe, xf, St, boot=booter)
    got.append(_digest(a))
    a = circ.affine(a, w.a1, w.b1, w.c1, St)
    got.append(_digest(a))
    y = circ.ffn(a, boot=booter)
    got.append(_digest(y))
    xm, ym = e.match(a, y)
    z = circ.affine(e.add(xm, ym), w.a2, w.b2, w.c2, St)
    got.append(_digest(circ.pooler_classifier(z, boot=booter)))
    assert got == FROZEN[mode]


def test_block_grid_matmul_matches_plain_product(ev):
    """A 3 x 2 grid of 8 x 8 blocks (24 outputs from 16 inputs) with a
    bias, and one zero block, against X W^T + b: CKKS noise at scale 2^26
    and n = 256 stays under 1e-3 per output for entries of this size (the
    one-block matmul test in test_torch_circuit_packed.py holds 2e-2)."""
    bops = BlockOps(ev, BLOCK, bs=BS)
    rng = np.random.default_rng(0)
    X = rng.normal(0, 0.5, (bops.nb, 16))
    W = rng.normal(0, 0.3, (24, 16))
    W[8:16, 0:8] = 0.0
    b = rng.normal(0, 0.2, 24)
    ct = ev.encrypt(bops.pack(X), batch=True)
    assert ct.c0.shape[:-2] == (2,)
    out = bops.matmul(ct, W, "grid", bias=b)
    assert out.c0.shape[:-2] == (3,)
    got = bops.unpack(np.real(ev.decrypt(out)), bops.nb)
    np.testing.assert_allclose(got, X @ W.T + b[None], atol=1e-3)


def test_counters(ev):
    """block_matmul counts each nonzero block product per ciphertext;
    pt_rows counts the residue rows the combo makes from coefficient
    plaintexts over the Q u P basis of the input's level: of a dense 8 x 8
    block's 15 diagonals (8 main, 7 wrap), the 12 that weight a baby
    rotation (at bs 4 the offsets 0, 4 and -4 have baby shift 0 and
    multiply the input as it is)."""
    bops = BlockOps(ev, BLOCK, bs=BS)
    rng = np.random.default_rng(1)
    W = rng.normal(0, 0.3, (16, 24))
    W[0:8, 8:16] = 0.0
    X = rng.normal(0, 0.5, (2 * bops.nb, 24))
    ct = ev.encrypt(bops.pack_chunks(X).reshape(-1, bops.slots), batch=True)
    ct = ct.with_data(ct.c0.reshape(2, 3, *ct.c0.shape[-2:]),
                      ct.c1.reshape(2, 3, *ct.c1.shape[-2:]))
    c = GLOBAL_TIMERS.counts
    before = c["block_matmul"], c["pt_rows"]
    bops.matmul(ct, W, "count")
    ks = ev.ctx.ks_tables(ct.nl)
    assert c["block_matmul"] - before[0] == 5 * 2          # 5 blocks x C=2
    assert c["pt_rows"] - before[1] == 5 * 12 * len(ks.tgt_idx)


def test_encode_many_is_encode():
    """Real and complex rows, the grid's tiled diagonals, and a row whose
    coefficient 0 sits at x.5 before rounding (decoded from coefficients
    [0.5, 0, ...] at scale 1, so the two FFTs may round it either way):
    each row of encode_many equals encode()'s."""
    enc = Encoder(1 << 10)
    rng = np.random.default_rng(2)
    rows = [rng.normal(0, 0.05, enc.slots), rng.normal(0, 0.3, 40),
            np.tile(rng.normal(0, 0.05, 8), enc.slots // 8)]
    cplx = rng.normal(0, 0.1, enc.slots) + 1j * rng.normal(0, 0.1, enc.slots)
    for Z, scale in ((np.stack([rows[0], rows[2]]), 2.0 ** 26),
                     (np.stack([np.pad(rows[1], (0, enc.slots - 40)),
                                rows[0]]), 2.0 ** 40),
                     (cplx[None], 2.0 ** 26)):
        got = enc.encode_many(Z, scale, "cpu").numpy()
        want = np.stack([enc.encode(z, scale) for z in Z])
        np.testing.assert_array_equal(got, want)
    c = np.zeros(enc.n)
    c[0] = 0.5
    tie = enc.decode(c, 1.0)
    np.testing.assert_array_equal(enc.encode_many(tie[None], 1.0, "cpu")[0],
                                  enc.encode(tie, 1.0))
