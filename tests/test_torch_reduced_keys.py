"""Reduced-basis rotation keys (KSKey.max_nl: q-limbs [0, max_nl) and the
specials) in the port against the JAX package, at n = 256 (9 q-limbs, 5
special, dnum 2), on ciphertexts the JAX package encrypted:

  * generate_keys(rotations_reduced=, reduced_max_nl=) gives JAX's `b`,
    `a`, `a_seed` and `max_nl` for every key, with a shift in both sets
    (it keeps its full key) and with a ceiling at or above num_q (full
    keys)
  * rotate, rotate_hoisted, rotate_combo, baby_key_stack and the BSGS
    transform (combo stage 1 and 2, multi_rotate_sum), each with full and
    reduced keys mixed, bit for bit at nl < max_nl and nl == max_nl
  * a key switch above max_nl raises in both packages
"""

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.linalg.packed import PackedOps as JPackedOps
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.linalg.packed import PackedOps

PARAMS = dict(n=256, scale_bits=26, num_scaling=8, dnum=2, seed=91)
SLOTS = PARAMS["n"] // 2
FULL = (1, 4, -2)
REDUCED = (1, 2, 3, -4)          # 1 is in both sets: it stays full
MAX_NL = 5


def _u32(t):
    return t.numpy().astype(np.uint32)


def _to_port(ctx, jkeys):
    a = np.asarray
    return convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a), k.max_nl) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a)))


@pytest.fixture(scope="module")
def env():
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**PARAMS))
    jkeys = jgenerate_keys(jctx, rotations=FULL, conj=True,
                           rotations_reduced=REDUCED, reduced_max_nl=MAX_NL)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    return (JEvaluator(jctx, jkeys), Evaluator(ctx, _to_port(ctx, jkeys)))


def _jct(jev, nl, seed, batch=2):
    z = np.random.default_rng(seed).uniform(-1, 1, (batch, SLOTS))
    return jev.encrypt(z, nl=nl, batch=True)


def _pct(ev, jct):
    return convert.ciphertext_from_numpy(ev.ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def _same(ct, jct):
    assert (ct.nl, ct.scale) == (jct.nl, jct.scale)
    np.testing.assert_array_equal(_u32(ct.c0), np.asarray(jct.c0))
    np.testing.assert_array_equal(_u32(ct.c1), np.asarray(jct.c1))


def _key_same(k, jk):
    assert (k.max_nl, k.a_seed) == (jk.max_nl, jk.a_seed)
    np.testing.assert_array_equal(_u32(k.b), np.asarray(jk.b))
    np.testing.assert_array_equal(_u32(k.a), np.asarray(jk.a))


@pytest.mark.parametrize("max_nl", [MAX_NL, 9, 12],
                         ids=["reduced", "at_num_q", "above_num_q"])
def test_reduced_keys_match_jax(max_nl):
    """The same keys in the same host draw order: full keys first, then
    the reduced shifts not already present; a ceiling >= num_q gives full
    keys with the full keys' seeds."""
    jkeys = jgenerate_keys(JContext(JConfig(**PARAMS)), rotations=FULL,
                           conj=True, rotations_reduced=REDUCED,
                           reduced_max_nl=max_nl)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    keys = generate_keys(ctx, rotations=FULL, conj=True,
                         rotations_reduced=REDUCED, reduced_max_nl=max_nl)
    assert list(keys.rot) == list(jkeys.rot)
    for r, jk in jkeys.rot.items():
        _key_same(keys.rot[r], jk)
        reduced = r not in FULL and max_nl < ctx.num_q
        assert keys.rot[r].max_nl == (max_nl if reduced else None)
        assert keys.rot[r].b.shape[1] == (max_nl if reduced else ctx.num_q) \
            + ctx.k_sp
    _key_same(keys.relin, jkeys.relin)
    _key_same(keys.conj, jkeys.conj)
    np.testing.assert_array_equal(_u32(keys.pk.p0), np.asarray(jkeys.pk.p0))


@pytest.mark.parametrize("nl", [MAX_NL, 3])
def test_rotate_mixed_keys_bit_exact(env, nl):
    jev, ev = env
    jct = _jct(jev, nl, 10 + nl)
    ct = _pct(ev, jct)
    _same(ev.rotate(ct, 3), jev.rotate(jct, 3))        # a reduced key
    shifts = [0, 1, 3, -4]                      # identity, full, reduced
    jout, out = jev.rotate_hoisted(jct, shifts), ev.rotate_hoisted(ct, shifts)
    for r in shifts:
        _same(out[r], jout[r])


@pytest.mark.parametrize("nl", [MAX_NL, 3])
def test_combo_mixed_babies_bit_exact(env, nl):
    """rotate_combo on coefficient plaintexts with an identity term, and
    the baby key stack, each over a full-basis baby (1) beside reduced
    ones (2, 3, -4)."""
    jev, ev = env
    jct = _jct(jev, nl, 20 + nl, batch=1)
    jct = jct.with_data(jct.c0[0], jct.c1[0])
    ct = _pct(ev, jct)
    rng = np.random.default_rng(nl)
    shifts = [0, 1, 2, 3, -4]
    diags = [rng.uniform(-1, 1, SLOTS) for _ in shifts]
    jitems = [(r, jev.encode_coeff_cached(("rk", r), d))
              for r, d in zip(shifts, diags)]
    items = [(r, ev.encode_coeff_cached(("rk", r), d))
             for r, d in zip(shifts, diags)]
    _same(ev.rotate_combo(ct, items), jev.rotate_combo(jct, jitems))
    babies = [1, 2, 3, -4]
    jkb, jka = jev.baby_key_stack(babies, nl)
    kb, ka = ev.baby_key_stack(babies, nl)
    np.testing.assert_array_equal(_u32(kb), np.asarray(jkb))
    np.testing.assert_array_equal(_u32(ka), np.asarray(jka))


@pytest.mark.parametrize("nl", [MAX_NL, 3])
def test_bsgs_transform_mixed_keys_bit_exact(env, nl):
    """PackedOps.bsgs_diag_transform over 8 diagonals (bs 4): babies 1
    (full), 2, 3 (reduced), giant 4 (full) through combo stage 1, the
    batched stage 2 and multi_rotate_sum."""
    jev, ev = env
    jct = _jct(jev, nl, 30 + nl, batch=1)
    jct = jct.with_data(jct.c0[0], jct.c1[0])
    rng = np.random.default_rng(40 + nl)
    diags = {k: rng.uniform(-1, 1, SLOTS) for k in range(8)}
    jout = JPackedOps(jev, d=16).bsgs_diag_transform(jct, diags, bs=4)
    out = PackedOps(ev, d=16).bsgs_diag_transform(_pct(ev, jct), diags, bs=4)
    _same(out, jout)


def test_keyswitch_above_max_nl_raises(env):
    """Level 6 > max_nl 5: JAX's assert and the port's ValueError, for a
    plain and a hoisted rotation and the baby key stack; the full keys
    still work."""
    jev, ev = env
    jct = _jct(jev, MAX_NL + 1, 50)
    ct = _pct(ev, jct)
    with pytest.raises(AssertionError, match="exceeds reduced key basis"):
        jev.rotate(jct, 3)
    with pytest.raises(ValueError, match="exceeds the reduced key basis"):
        ev.rotate(ct, 3)
    with pytest.raises(ValueError, match="exceeds the reduced key basis"):
        ev.rotate_hoisted(ct, [1, -4])
    with pytest.raises(ValueError, match="exceeds the reduced key basis"):
        ev.baby_key_stack([1, 2], MAX_NL + 1)
    _same(ev.rotate(ct, 4), jev.rotate(jct, 4))
