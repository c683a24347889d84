"""The port's CKKS layer (context tables, key generation, encoding and the
key-switch / rescale cores) against the JAX package, bit-exact, on
ciphertexts the JAX package made and handed over as numpy arrays through
fhe_linformer_tpu_torch.convert.  Encryption noise cannot match (JAX
samples it with threefry), so the port's own encryption is checked by
decrypt error against the JAX package's tolerance in tests/test_ckks.py.
The conjugation key and `conjugate` (the bootstrap's) are held here too."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.ckks import evaluator as jevm
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.ckks import evaluator as evm
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.ops import moddown

PARAMS = dict(n=1 << 11, scale_bits=26, num_scaling=7, dnum=3, seed=31,
              secret_hw=32)
ROTS = (1, -2, 5)


def _keys_to_port(ctx, jkeys):
    a = np.asarray
    return convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a)))


@pytest.fixture(scope="module")
def env():
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**PARAMS))
    jkeys = jgenerate_keys(jctx, rotations=ROTS, conj=True)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    return jctx, JEvaluator(jctx, jkeys), ctx, _keys_to_port(ctx, jkeys)


def _u32(t):
    return t.numpy().astype(np.uint32)


def _jct(jev, nl, seed, batch=2):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 1, (batch, jev.ctx.cfg.slots))
    return jev.encrypt(z, nl=nl, batch=True)


def _pct(ctx, jct):
    return convert.ciphertext_from_numpy(ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def test_chain_and_tables_match(env):
    jctx, _, ctx, _ = env
    assert (ctx.qs, ctx.ps, ctx.alpha) == (jctx.qs, jctx.ps, jctx.alpha)
    for nl in (ctx.num_q, 5, 1):
        jks, ks = jctx.ks_tables(nl), ctx.ks_tables(nl)
        assert ks.tgt_idx == jks.tgt_idx
        assert ks.groups == tuple(d.group for d in jks.digits)
        for name in ("fold", "fold_s", "gq", "conv"):
            for jt, t in ((jks.bc, ks.bc), (jks.md, ks.md)):
                np.testing.assert_array_equal(
                    _u32(getattr(t, name)).reshape(np.shape(getattr(jt, name))),
                    np.asarray(getattr(jt, name)))
        np.testing.assert_array_equal(_u32(ks.bc.q_out), np.asarray(jks.bc.q))
        for name in ("pfold", "pinv", "pmod", "own", "mdq40", "q_act", "q_tgt",
                     "q_sp"):
            np.testing.assert_array_equal(_u32(getattr(ks, name)),
                                          np.asarray(getattr(jks, name)))
    for nl in (ctx.num_q, 2):
        jp, p = jctx.rescale_tables(nl), ctx.rescale_tables(nl)
        assert p.half == int(np.asarray(jp.half)[0, 0])
        for name in ("inv", "qrem", "qdm"):
            np.testing.assert_array_equal(_u32(getattr(p, name)),
                                          np.asarray(getattr(jp, name)))
    for r in ROTS:
        t = ctx.galois_t(r)
        assert t == jctx.galois_t(r)
        np.testing.assert_array_equal(ctx.galois_perm(t).numpy(),
                                      np.asarray(jctx.galois_perm(t)))


def test_keys_match(env):
    jctx, jev, ctx, _ = env
    keys = generate_keys(ctx, rotations=ROTS)
    jk = jev.keys
    np.testing.assert_array_equal(keys.sk.coeffs, jk.sk.coeffs)
    pairs = [(keys.sk.eval_full, jk.sk.eval_full), (keys.pk.p0, jk.pk.p0),
             (keys.pk.p1, jk.pk.p1), (keys.relin.b, jk.relin.b),
             (keys.relin.a, jk.relin.a)]
    for r in ROTS:
        pairs += [(keys.rot[r].b, jk.rot[r].b), (keys.rot[r].a, jk.rot[r].a)]
    for got, want in pairs:
        np.testing.assert_array_equal(_u32(got), np.asarray(want))


def test_encode_bit_exact(env):
    _, jev, ctx, keys = env
    ev = Evaluator(ctx, keys)
    rng = np.random.default_rng(4)
    z = rng.uniform(-1, 1, ctx.cfg.slots)
    zb = rng.uniform(-1, 1, (3, ctx.cfg.slots))
    for kw in (dict(), dict(nl=3), dict(scale=2.0 ** 30)):
        np.testing.assert_array_equal(_u32(ev.encode(z, **kw).data),
                                      np.asarray(jev.encode(z, **kw).data))
    np.testing.assert_array_equal(_u32(ev.encode(zb, nl=5, batch=True).data),
                                  np.asarray(jev.encode(zb, nl=5, batch=True)
                                             .data))
    c = ev.encode_const(-0.37, nl=4)
    np.testing.assert_array_equal(_u32(c.data),
                                  np.asarray(jev.encode_const(-0.37, nl=4).data))


def test_conjugation_key_match(env):
    """generate_keys(conj=True) draws the conjugation key after the
    rotation keys, as the JAX package does, so it equals the JAX key; so
    does the one carried over by convert (measured 0.2 s)."""
    _, jev, ctx, keys = env
    mine = generate_keys(ctx, rotations=ROTS, conj=True)
    jk = jev.keys
    assert generate_keys(ctx).conj is None
    for got in (mine.conj, keys.conj):
        np.testing.assert_array_equal(_u32(got.b), np.asarray(jk.conj.b))
        np.testing.assert_array_equal(_u32(got.a), np.asarray(jk.conj.a))
    np.testing.assert_array_equal(_u32(mine.rot[ROTS[-1]].b),
                                  np.asarray(jk.rot[ROTS[-1]].b))


@pytest.mark.parametrize("nl", [8, 3])
def test_conjugate_bit_exact(env, nl):
    """Complex conjugation (the key switch by X -> X^-1) on a JAX-made
    batch of complex slot vectors (measured 6 s and 3 s)."""
    jctx, jev, ctx, keys = env
    rng = np.random.default_rng(60 + nl)
    z = rng.uniform(-1, 1, (2, ctx.cfg.slots)) + \
        1j * rng.uniform(-1, 1, (2, ctx.cfg.slots))
    jct = jev.encrypt(z, nl=nl, batch=True)
    jout = jev.conjugate(jct)
    ev = Evaluator(ctx, keys)
    out = ev.conjugate(_pct(ctx, jct))
    assert (out.nl, out.scale) == (jout.nl, jout.scale)
    np.testing.assert_array_equal(_u32(out.c0), np.asarray(jout.c0))
    np.testing.assert_array_equal(_u32(out.c1), np.asarray(jout.c1))
    np.testing.assert_allclose(ev.decrypt(out), np.conj(z), atol=1e-3)


@pytest.mark.parametrize("nl", [8, 5, 2])
def test_galois_core_bit_exact(env, nl):
    jctx, jev, ctx, keys = env
    r = ROTS[nl % len(ROTS)]
    jct = _jct(jev, nl, seed=nl)
    t = jctx.galois_t(r)
    kb, ka = jev._sliced_key(jev.keys.rot[r], nl)
    w0, w1 = jevm._galois_core(jct.c0, jct.c1, jctx.galois_perm_factored(t),
                               kb, ka, jctx.ks_tables(nl))
    ct = _pct(ctx, jct)
    g0, g1 = evm._galois_core(ctx, ct.c0, ct.c1, ctx.galois_perm(t),
                              keys.rot[r], ctx.ks_tables(nl))
    np.testing.assert_array_equal(_u32(g0), np.asarray(w0))
    np.testing.assert_array_equal(_u32(g1), np.asarray(w1))


@pytest.mark.parametrize("nl", [8, 3])
def test_mul_relin_core_bit_exact(env, nl):
    jctx, jev, ctx, keys = env
    a, b = _jct(jev, nl, seed=10 + nl), _jct(jev, nl, seed=20 + nl)
    kb, ka = jev._sliced_key(jev.keys.relin, nl)
    w0, w1 = jevm._mul_relin_core(a.c0, a.c1, b.c0, b.c1, kb, ka,
                                  jctx.ks_tables(nl))
    pa, pb = _pct(ctx, a), _pct(ctx, b)
    g0, g1 = evm._mul_relin_core(ctx, pa.c0, pa.c1, pb.c0, pb.c1, keys.relin,
                                 ctx.ks_tables(nl))
    np.testing.assert_array_equal(_u32(g0), np.asarray(w0))
    np.testing.assert_array_equal(_u32(g1), np.asarray(w1))


@pytest.mark.parametrize("nl", [8, 4, 2])
def test_rescale_bit_exact(env, nl):
    jctx, jev, ctx, _ = env
    jct = _jct(jev, nl, seed=30 + nl)
    w0, w1 = jevm._rescale_core(jct.c0, jct.c1, jctx.rescale_tables(nl))
    ct = _pct(ctx, jct)
    g0, g1 = evm._rescale_body(ctx, ct.c0, ct.c1, ctx.rescale_tables(nl))
    np.testing.assert_array_equal(_u32(g0), np.asarray(w0))
    np.testing.assert_array_equal(_u32(g1), np.asarray(w1))


@pytest.mark.parametrize("nl", [8, 1])
def test_mod_down_bit_exact(env, nl):
    """Random residues over Q_l * P: covers the f32 overflow estimate
    (_md_overflow) and the prefolded P -> Q_l conversion."""
    jctx, _, ctx, _ = env
    rng = np.random.default_rng(40 + nl)
    qs = [ctx.basis[i] for i in ctx.limb_idx(nl, specials=True)]
    x = np.stack([[rng.integers(0, q, ctx.cfg.n, dtype=np.uint32) for q in qs]
                  for _ in range(2)])
    jks = jctx.ks_tables(nl)
    want = np.asarray(jevm._mod_down(jnp.asarray(x), jks))
    got = evm._mod_down(ctx, torch.from_numpy(x.astype(np.int32)),
                        ctx.ks_tables(nl))
    np.testing.assert_array_equal(_u32(got), want)
    w = np.stack([rng.integers(0, p, ctx.cfg.n, dtype=np.uint32)
                  for p in ctx.ps])
    np.testing.assert_array_equal(
        _u32(moddown.md_overflow(torch.from_numpy(w.astype(np.int32)),
                              ctx.ks_tables(nl).mdq40)),
        np.asarray(jevm._md_overflow(jnp.asarray(w), jks.mdq40)))


def test_encrypt_decrypt_error():
    """The port's encryption (torch.Generator noise), decrypted, within the
    JAX package's own tolerance at its test ring (tests/test_ckks.py)."""
    cfg = CKKSConfig(n=256, scale_bits=26, num_scaling=6, dnum=2, seed=123)
    ctx = Context(cfg, device="cpu")
    ev = Evaluator(ctx, generate_keys(ctx))
    z = np.random.default_rng(1).uniform(-1, 1, cfg.slots)
    ct = ev.encrypt(z)
    np.testing.assert_allclose(np.real(ev.decrypt(ct)), z, atol=2e-4)
    np.testing.assert_allclose(np.real(ev.decrypt_host(ct)), z, atol=2e-4)


def test_decrypt_jax_ciphertext(env):
    """The port decrypts a JAX-made ciphertext to the JAX decrypt's values."""
    _, jev, ctx, keys = env
    jct = _jct(jev, 4, seed=50)
    want = np.asarray(jev.decrypt(jct))
    got = Evaluator(ctx, keys).decrypt(_pct(ctx, jct))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    c0, c1, nl, scale = convert.ciphertext_to_numpy(_pct(ctx, jct))
    np.testing.assert_array_equal(c0, np.asarray(jct.c0))
    assert (nl, scale) == (jct.nl, jct.scale)
