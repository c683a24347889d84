"""Evaluator.decrypt_slots_device in the port against the JAX package, at
tests/test_ckks.py's n = 256 chain (6 scaling limbs, dnum 2), on
ciphertexts the JAX package encrypted:

  * its integer steps (c0 + c1*s, the inverse NTT, t_i, the overflow k,
    the low word y, the centred carry c) bit for bit against the JAX
    package's expressions, evaluated here step by step with its
    ops/modarith.py, on a fresh and a multiplied ciphertext, negative
    carries included
  * the slot values against the port's host decrypt at the JAX tests'
    tolerances (5e-4 fresh and after `mul`, 5e-3 batched), and against
    the JAX package's own decrypt_slots_device on the same ciphertext
  * the balanced float planes (the port's one departure: lo, hi in
    [-2^15, 2^15], where the JAX package's unsigned halves cancel in
    float32) rebuild x exactly and decode within 1e-6 of the host decrypt
  * it raises without keys and under TF32 matmuls, and caches its tables
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.ops import modarith as jma
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.ckks import evaluator as evm
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator

PARAMS = dict(n=256, scale_bits=26, num_scaling=6, dnum=2, seed=123)
SLOTS = PARAMS["n"] // 2
IDX = [0, 3, 17, 100, SLOTS - 1]
# the JAX package's float32 decode lies up to 2.3e-4 from the float64 host
# decrypt here (its unsigned hi16 and carry planes' dot products cancel),
# the port's balanced planes within 1e-7
VS_JAX_ATOL = 5e-4


def _port_keys(ctx, jkeys):
    a = np.asarray
    return convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)), {})


@pytest.fixture(scope="module")
def env():
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**PARAMS))
    jkeys = jgenerate_keys(jctx)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    return JEvaluator(jctx, jkeys), Evaluator(ctx, _port_keys(ctx, jkeys))


def _z(seed):
    return np.random.default_rng(seed).uniform(-1, 1, SLOTS)


def _pct(ev, jct):
    return convert.ciphertext_from_numpy(ev.ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def _cts(jev):
    """A fresh ciphertext at the top level and its square (relinearized,
    rescaled)."""
    jct = jev.encrypt(_z(7))
    return {"fresh": jct, "mul": jev.mul(jct, jct)}


def _jax_steps(jev, jct, m):
    """The JAX package's decrypt_slots_device and _slots_from_residues,
    step by step up to the float decode, in its own u32 arithmetic."""
    ctx = jev.ctx
    jct = jev.drop_to(jct, m)
    limbs = ctx.limb_idx(m)
    q, mu, sh = ctx.mod_consts(limbs)
    me = jma.addmod(jct.c0, jma.barrett_mulmod(
        jct.c1, jev.keys.sk.eval_full[:m], q, mu, sh), q)
    r = ctx.ntt.inv(me, limbs)
    qs = [int(x) for x in ctx.qs[:m]]
    big_q = 1
    for x in qs:
        big_q *= x
    inv_t = jnp.asarray(np.asarray([pow(big_q // qi, -1, qi) for qi in qs],
                                   np.uint32).reshape(-1, 1))
    u_i = jnp.asarray(np.asarray([(big_q // qi) % (1 << 32) for qi in qs],
                                 np.uint32).reshape(-1, 1))
    uq = np.uint32(big_q % (1 << 32))
    inv32 = np.uint32(pow((1 << 32) % qs[0], -1, qs[0]))
    t = jma.barrett_mulmod(r, inv_t, q, mu, sh)
    frac = jnp.sum(t.astype(jnp.float32) / q.astype(jnp.float32), axis=-2)
    k = jnp.round(frac).astype(jnp.uint32)
    y = jnp.sum(jma.mullo32(t, u_i), axis=-2, dtype=jnp.uint32)
    y = y - jma.mullo32(k, uq)
    q0, mu0, sh0 = q[0], mu[0], sh[0]
    d = jma.submod(r[..., 0, :], y % q0, q0)
    c = jma.barrett_mulmod(d, inv32, q0, mu0, sh0)
    ci = c.astype(jnp.int32)
    q0i = q0.astype(jnp.int32)
    cf = jnp.where(ci > q0i // 2, ci - q0i, ci)
    return {"me": me, "r": r, "t": t, "k": k, "y": y, "c": cf}


@pytest.mark.parametrize("which", ["fresh", "mul"])
def test_integer_steps_bit_exact(env, which):
    jev, ev = env
    jct = _cts(jev)[which]
    m = 3
    want = _jax_steps(jev, jct, m)
    ct = ev.drop_to(_pct(ev, jct), m)
    r = ev._coeff_residues(ct, "test")
    q = ev.ctx.mod(ev.ctx.limb_idx(m))
    sk = ev.keys.sk.eval_full[:m]
    me = evm.addmod(ct.c0, evm.mulmod(ct.c1, sk, q), q)
    t, k, y, c = evm._crt_low_and_carry(
        r, q, evm._slot_tables(ev.ctx, ev.encoder, m, IDX))
    for name, got in (("me", me), ("r", r), ("t", t), ("k", k), ("y", y)):
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want["c"]))
    # the negative-carry centring: a negative coefficient x has y near 2^32
    # and carry -1 (q0 - 1 before centring, which a float32 centring maps
    # to 0)
    assert (c == -1).any() and (c == 0).any()
    assert int(y[c == -1].min()) > 1 << 31


@pytest.mark.parametrize("which", ["fresh", "mul"])
def test_balanced_planes(env, which):
    """x = lo + 2^16 hi + 2^32 c' exactly, lo and hi within 2^15, the
    small negative coefficients carrying 0; the decode within 1e-6 of the
    host decrypt."""
    jev, ev = env
    ct = ev.drop_to(_pct(ev, _cts(jev)[which]), 3)
    q = ev.ctx.mod(ev.ctx.limb_idx(3))
    _, _, y, c = evm._crt_low_and_carry(
        ev._coeff_residues(ct, "test"), q,
        evm._slot_tables(ev.ctx, ev.encoder, 3, IDX))
    lo, hi, c2 = evm._balanced_planes(y, c)
    assert torch.equal(lo + (hi << 16) + (c2 << 32), y + (c << 32))
    assert int(lo.abs().max()) <= 1 << 15 and int(hi.abs().max()) <= 1 << 15
    assert (c == -1).any() and not c2.any()
    np.testing.assert_allclose(ev.decrypt_slots_device(ct, IDX),
                               np.real(ev.decrypt_host(ct))[IDX], atol=1e-6)


@pytest.mark.parametrize("which", ["fresh", "mul"])
def test_slots_match_host_decrypt(env, which):
    jev, ev = env
    ct = _pct(ev, _cts(jev)[which])
    dev = ev.decrypt_slots_device(ct, IDX)
    assert dev.dtype == np.float32 and dev.shape == (len(IDX),)
    host = np.real(ev.decrypt_host(ct))
    np.testing.assert_allclose(dev, host[IDX], atol=5e-4)


def test_slots_batched(env):
    """A batch of 3 decodes per element, within 5e-3 of the messages and
    5e-4 of the host decrypt."""
    jev, ev = env
    zs = np.stack([_z(11 + i) for i in range(3)])
    ct = _pct(ev, jev.encrypt(zs, batch=True))
    idx = [2, 5, 64]
    dev = ev.decrypt_slots_device(ct, idx)
    assert dev.shape == (3, len(idx))
    np.testing.assert_allclose(dev, zs[:, idx], atol=5e-3)
    np.testing.assert_allclose(dev, np.real(ev.decrypt_host(ct))[:, idx],
                               atol=5e-4)


@pytest.mark.parametrize("which", ["fresh", "mul"])
def test_slots_match_jax(env, which):
    jev, ev = env
    jct = _cts(jev)[which]
    want = jev.decrypt_slots_device(jct, IDX)
    got = ev.decrypt_slots_device(_pct(ev, jct), IDX)
    np.testing.assert_allclose(got, want, atol=VS_JAX_ATOL, rtol=0)


def test_tables_cached_and_refusals(env):
    jev, ev = env
    ct = _pct(ev, jev.encrypt(_z(3)))
    ev.decrypt_slots_device(ct, IDX)
    tab = ev._slotdec_cache[(3, tuple(IDX))]
    ev.decrypt_slots_device(ct, IDX)
    assert ev._slotdec_cache[(3, tuple(IDX))] is tab
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="true float32"):
            ev.decrypt_slots_device(ct, IDX)
    finally:
        torch.set_float32_matmul_precision(prec)
    bare = Evaluator(ev.ctx, ev.keys)
    bare.release_device_keys()
    with pytest.raises(RuntimeError, match="needs keys"):
        bare.decrypt_slots_device(ct, IDX)
