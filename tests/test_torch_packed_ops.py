"""The port's evaluator and PackedOps additions against the JAX package at
n = 256 (tests/test_linalg.py's chain: 8 scaling limbs, dnum 2, d = 16,
nb = 8 blocks), each fed the same JAX-encrypted ciphertext and compared bit
for bit: residues, (nl, scale) and key-switch counts.

  * evaluator: add_many, neg, sub_plain, rotate_hoisted, rotate_combo (eval
    and coefficient plaintexts, with an identity term), combo_from_decomp,
    baby_key_stack, release_device_keys / decrypt_host, the probes
  * PackedOps: required_rotations, the slot layouts, matmul_re, matmul_cr,
    matmul_bsgs, unwrap_to_repeated, wrap_up_repeated, wrap_up_expanded,
    unwrap_expanded, and bsgs_diag_transform's hoisted branch (the JAX
    package's FHE_BSGS_COMBO=0) in its four rescale modes
"""

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.ckks.evaluator import \
    _hoist_decompose_core as j_hoist_decompose
from fhe_linformer_tpu.linalg.packed import PackedOps as JPackedOps
from fhe_linformer_tpu.utils.timing import GLOBAL_TIMERS as JTIMERS
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.linalg.packed import PackedOps
from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS

PARAMS = dict(n=256, scale_bits=26, num_scaling=8, dnum=2, seed=777)
D = 16
SLOTS = PARAMS["n"] // 2


def _rotations():
    pow2, s = [], 1
    while s < SLOTS:
        pow2 += [s, -s]
        s *= 2
    return tuple(sorted(set(pow2 + list(range(1, 8)) + [8, 12, 16, 24])))


@pytest.fixture(scope="module")
def env():
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**PARAMS))
    jkeys = jgenerate_keys(jctx, rotations=_rotations())
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    a = np.asarray
    keys = convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()})
    jev, ev = JEvaluator(jctx, jkeys), Evaluator(ctx, keys)
    return JPackedOps(jev, d=D), PackedOps(ev, d=D)


def _ct(ops, jct):
    return convert.ciphertext_from_numpy(ops.ev.ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def _same(ct, jct):
    assert (ct.nl, ct.scale) == (jct.nl, jct.scale)
    c0, c1, _, _ = convert.ciphertext_to_numpy(ct)
    np.testing.assert_array_equal(c0, np.asarray(jct.c0))
    np.testing.assert_array_equal(c1, np.asarray(jct.c1))


def _both(jrun, run):
    """Runs both; equal results and equal key-switch counts."""
    k0, jk0 = GLOBAL_TIMERS.counts["keyswitch"], JTIMERS.counts["keyswitch"]
    jout, out = jrun(), run()
    assert GLOBAL_TIMERS.counts["keyswitch"] - k0 == \
        JTIMERS.counts["keyswitch"] - jk0
    return jout, out


def _enc(jops, seed, batch=None, nl=None):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-1, 1, (batch or 1, SLOTS))
    jct = jops.ev.encrypt(v if batch else v[0], batch=bool(batch), nl=nl)
    return v if batch else v[0], jct


def test_layout_helpers_equal(env):
    jops, ops = env
    rng = np.random.default_rng(0)
    v, W = rng.normal(size=5), rng.normal(size=(6, 11))
    assert ops.required_rotations() == jops.required_rotations()
    for name, arg in (("expanded_slots", v), ("repeated_slots", v),
                      ("matrix_cr_slots", W)):
        np.testing.assert_array_equal(getattr(ops, name)(arg),
                                      getattr(jops, name)(arg))


def test_add_many_neg_sub_plain(env):
    jops, ops = env
    jev, ev = jops.ev, ops.ev
    jcts = [_enc(jops, s)[1] for s in (1, 2, 3)]
    cts = [_ct(ops, c) for c in jcts]
    _same(ev.add_many(cts), jev.add_many(jcts))
    _same(ev.neg(cts[0]), jev.neg(jcts[0]))
    vals = np.random.default_rng(4).uniform(-1, 1, SLOTS)
    jpt, pt = jev.encode(vals, nl=jcts[1].nl), ev.encode(vals, nl=cts[1].nl)
    _same(ev.sub_plain(cts[1], pt), jev.sub_plain(jcts[1], jpt))


@pytest.mark.parametrize("batch", [None, 3], ids=["single", "batch3"])
def test_rotate_hoisted(env, batch):
    jops, ops = env
    _, jct = _enc(jops, 5, batch=batch)
    shifts = [0, 1, 3, -4, 24]
    jout, out = _both(lambda: jops.ev.rotate_hoisted(jct, shifts),
                      lambda: ops.ev.rotate_hoisted(_ct(ops, jct), shifts))
    assert set(out) == set(shifts)
    for r in shifts:
        _same(out[r], jout[r])


@pytest.mark.parametrize("coeff", [False, True], ids=["eval_pt", "coeff_pt"])
def test_rotate_combo(env, coeff):
    """sum_j pt_j * rotate(ct, r_j) with an identity term, on eval
    plaintexts over the extended basis or coefficient plaintexts."""
    jops, ops = env
    jev, ev = jops.ev, ops.ev
    _, jct = _enc(jops, 6, nl=6)
    rng = np.random.default_rng(7)
    shifts = [0, 2, 5, -8]
    diags = [rng.uniform(-1, 1, SLOTS) for _ in shifts]
    if coeff:
        jitems = [(r, jev.encode_coeff_cached(("c", r), d))
                  for r, d in zip(shifts, diags)]
        items = [(r, ev.encode_coeff_cached(("c", r), d))
                 for r, d in zip(shifts, diags)]
    else:
        jitems = [(r, jev.encode(d, nl=jct.nl, specials=True))
                  for r, d in zip(shifts, diags)]
        items = [(r, ev.encode(d, nl=jct.nl, specials=True))
                 for r, d in zip(shifts, diags)]
    jout, out = _both(lambda: jev.rotate_combo(jct, jitems),
                      lambda: ev.rotate_combo(_ct(ops, jct), items))
    _same(out, jout)
    got = np.real(ev.decrypt(ev.rescale(out)))
    want = sum(d * np.roll(np.real(ev.decrypt(_ct(ops, jct))), -r)
               for r, d in zip(shifts, diags))
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_combo_from_decomp_and_key_stack(env):
    jops, ops = env
    jev, ev = jops.ev, ops.ev
    _, jct = _enc(jops, 8, nl=5)
    ct = _ct(ops, jct)
    jks, ks = jev.ctx.ks_tables(jct.nl), ev.ctx.ks_tables(ct.nl)
    rng = np.random.default_rng(9)
    shifts = [1, 3, 12]
    diags = [rng.uniform(-1, 1, SLOTS) for _ in shifts]
    jitems = [(r, jev.encode(d, nl=jct.nl, specials=True))
              for r, d in zip(shifts, diags)]
    items = [(r, ev.encode(d, nl=ct.nl, specials=True))
             for r, d in zip(shifts, diags)]
    y_e = ev.hoist_decompose(ct, ks)
    np.testing.assert_array_equal(
        y_e.numpy().astype(np.uint32), np.asarray(j_hoist_decompose(jct.c1,
                                                                    jks)))
    jout, out = _both(lambda: jev.combo_from_decomp(
        jct, j_hoist_decompose(jct.c1, jks), jitems, jks),
        lambda: ev.combo_from_decomp(ct, y_e, items, ks))
    _same(out, jout)
    jkb, jka = jev.baby_key_stack(shifts, jct.nl)
    kb, ka = ev.baby_key_stack(shifts, ct.nl)
    np.testing.assert_array_equal(kb.numpy().astype(np.uint32), np.asarray(jkb))
    np.testing.assert_array_equal(ka.numpy().astype(np.uint32), np.asarray(jka))
    assert ev.baby_key_stack(shifts, ct.nl)[0] is kb        # cached


def test_matmul_re_cr_bsgs(env):
    jops, ops = env
    jev, ev = jops.ev, ops.ev
    rng = np.random.default_rng(10)
    x = rng.uniform(-1, 1, ops.nb)
    W = rng.uniform(-1, 1, (D, ops.nb))
    b = rng.uniform(-1, 1, D)
    jct = jev.encrypt(jops.expanded_slots(x))
    ct = _ct(ops, jct)
    jout, out = _both(lambda: jops.matmul_re(jct, jev.encode(
        jops.matrix_re_slots(W), nl=jct.nl), jops.repeated_slots(b)),
        lambda: ops.matmul_re(ct, ev.encode(ops.matrix_re_slots(W),
                                            nl=ct.nl), ops.repeated_slots(b)))
    _same(out, jout)
    Wc = rng.uniform(-1, 1, (ops.nb, D))
    jct2 = jev.encrypt(jops.repeated_slots(rng.uniform(-1, 1, D)))
    ct2 = _ct(ops, jct2)
    jout, out = _both(lambda: jops.matmul_cr(jct2, jev.encode(
        jops.matrix_cr_slots(Wc), nl=jct2.nl)),
        lambda: ops.matmul_cr(ct2, ev.encode(ops.matrix_cr_slots(Wc),
                                             nl=ct2.nl)))
    _same(out, jout)
    Wb = rng.uniform(-0.5, 0.5, (8, 8))
    xb = np.tile(rng.uniform(-1, 1, 8), SLOTS // 8)
    jct3 = jev.encrypt(xb)
    jout, out = _both(lambda: jops.matmul_bsgs(jct3, Wb),
                      lambda: ops.matmul_bsgs(_ct(ops, jct3), Wb))
    _same(out, jout)
    got = np.real(ev.decrypt(out))[:8]
    np.testing.assert_allclose(got, Wb @ xb[:8], atol=1e-2)


def test_wrap_unwrap_helpers(env):
    jops, ops = env
    jev, ev = jops.ev, ops.ev
    jcts = [_enc(jops, 20 + j)[1] for j in range(3)]
    cts = [_ct(ops, c) for c in jcts]
    _same(ops.wrap_up_repeated(cts), jops.wrap_up_repeated(jcts))
    jout, out = _both(lambda: jops.wrap_up_expanded(jcts),
                      lambda: ops.wrap_up_expanded(cts))
    _same(out, jout)
    jout, out = _both(lambda: jops.unwrap_expanded(jcts[0], 2),
                      lambda: ops.unwrap_expanded(cts[0], 2))
    _same(out, jout)
    jb = jev.encrypt(np.random.default_rng(23).uniform(-1, 1, SLOTS))
    jout, out = _both(lambda: jops.unwrap_to_repeated(jb, 4),
                      lambda: ops.unwrap_to_repeated(_ct(ops, jb), 4))
    _same(out, jout)


@pytest.mark.parametrize("mode", ["single", "double", "raise", "lower"])
def test_bsgs_hoisted_branch(env, mode, monkeypatch):
    """bsgs_diag_transform without the combo (the JAX package under
    FHE_BSGS_COMBO=0): hoisted babies, per-level plaintexts, giant
    rotations with dedicated keys."""
    jops, ops = env
    monkeypatch.setenv("FHE_BSGS_COMBO", "0")
    hops = PackedOps(ops.ev, d=D, bsgs_combo=False)
    rng = np.random.default_rng(30)
    diags = {k: rng.uniform(-0.5, 0.5, SLOTS) for k in (0, 1, 3, 4, 6, 7)}
    _, jct = _enc(jops, 31)
    jout, out = _both(
        lambda: jops.bsgs_diag_transform(jct, diags, 4, rescale_mode=mode),
        lambda: hops.bsgs_diag_transform(_ct(ops, jct), diags, 4,
                                         rescale_mode=mode))
    _same(out, jout)


def test_release_keys_and_probes(env):
    _, ops = env
    ev = Evaluator(ops.ev.ctx, ops.ev.keys)
    v = np.random.default_rng(40).uniform(-1, 1, SLOTS)
    ct = ev.encrypt(v)
    assert np.allclose(ev.probe(ct, 4), v[:4], atol=1e-3)
    np.testing.assert_allclose(ev.probe_expanded(ct, 4, 3), v[:12:4],
                               atol=1e-3)
    np.testing.assert_allclose(ev.probe_padded(ct, 2, 3), v[:6:2], atol=1e-3)
    lo, hi = ev.probe_min_max(ct)
    assert abs(lo - v.min()) < 1e-3 and abs(hi - v.max()) < 1e-3
    ev.release_device_keys()
    np.testing.assert_allclose(np.real(ev.decrypt_host(ct)), v, atol=1e-3)
    with pytest.raises(RuntimeError, match="release_device_keys"):
        ev.rotate(ct, 1)


def test_heavy_and_fused_chunk_do_not_change_results(env):
    """Evaluator(heavy_chunk=, fused_chunk=) (the JAX package's
    FHE_HEAVY_CHUNK / FHE_FUSED_CHUNK) only splits the batch."""
    jops, ops = env
    _, jct = _enc(jops, 50, batch=5, nl=6)
    ct = _ct(ops, jct)
    small = Evaluator(ops.ev.ctx, ops.ev.keys, heavy_chunk=2, fused_chunk=3)
    assert (small.heavy_chunk, small.fused_chunk) == (2, 3)
    for f in (lambda ev: ev.rotate(ct, 3), lambda ev: ev.mul(ct, ct),
              lambda ev: ev.square_double_minus_one(ct)):
        a, b = f(ops.ev), f(small)
        assert torch.equal(a.c0, b.c0) and torch.equal(a.c1, b.c1)


@pytest.mark.parametrize("combo", [True, False], ids=["combo", "hoisted"])
def test_diagonal_plaintexts_follow_a_new_dict(env, combo):
    """bsgs_diag_transform caches its plaintexts under the diagonal dict's
    id(): once a caller drops one dict, a new dict on the same evaluator
    must get its own plaintexts, not the dropped dict's (CPython gives the
    next dict a display or comprehension makes a freed dict's address)."""
    _, ops = env
    ev = Evaluator(ops.ev.ctx, ops.ev.keys)
    pops = PackedOps(ev, d=D, bsgs_combo=combo)
    rng = np.random.default_rng(60)
    offsets = (0, 1, 3, 4, 6, 7)
    ct = ev.encrypt(rng.uniform(-1, 1, SLOTS))
    first = {k: rng.uniform(-0.5, 0.5, SLOTS) for k in offsets}
    values = [rng.uniform(-0.5, 0.5, SLOTS) for _ in offsets]
    pops.bsgs_diag_transform(ct, first, 4)
    del first
    second = {k: v for k, v in zip(offsets, values)}
    got = pops.bsgs_diag_transform(ct, second, 4)
    fresh = PackedOps(Evaluator(ops.ev.ctx, ops.ev.keys), d=D,
                      bsgs_combo=combo).bsgs_diag_transform(ct, second, 4)
    assert (got.nl, got.scale) == (fresh.nl, fresh.scale)
    assert torch.equal(got.c0, fresh.c0) and torch.equal(got.c1, fresh.c1)
