"""The port's bootstrap (fhe_linformer_tpu_torch.boot) and the wide-scale
pieces under it, against the JAX package, at the JAX package's own
bootstrap test configuration (tests/test_bootstrap.py: n = 256, 28 scaling
limbs, dnum 4, secret_hw 8, budget (2, 2), K = 8, sine degree 119, one
double angle).  Keys are the JAX package's, handed over through
fhe_linformer_tpu_torch.convert, and every bit-exact check starts from a
JAX-made ciphertext.

  * the transform plan (stages, groups, diagonals) at n = 256 and 2^12, and
    the production plan at 2^15 (46 rotations, bs 8)
  * the wide Chebyshev nodes, PolyEvaluator(wide=True), the BSGS transform
    in its four rescale modes, mod-raise, plaintexts at a 2^52 scale:
    bit-exact, with equal (nl, scale)
  * the port's whole bootstrap (narrow; wide with scale_boost 4) against
    simulate() and the JAX tests' precision floors; bootstrap2; chunking
  * (slow) the whole bootstrap, narrow and wide, bit-exact vs JAX; the
    production bootstrap's level accounting (linformer-boot-w's chain at
    ring 2^12), bit-exact vs JAX
"""

import math

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.boot import transform as jtf
from fhe_linformer_tpu.boot.bootstrap import BootConfig as JBootConfig
from fhe_linformer_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.ckks import evaluator as jevm
from fhe_linformer_tpu.linalg.packed import PackedOps as JPackedOps
from fhe_linformer_tpu.poly.eval import PolyEvaluator as JPolyEvaluator
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.boot import transform as tf
from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.linalg.packed import PackedOps
from fhe_linformer_tpu_torch.poly.cheb import chebyshev_fit
from fhe_linformer_tpu_torch.poly.eval import PolyEvaluator
from fhe_linformer_tpu_torch.utils.timing import (GLOBAL_TIMERS,
                                                  approx_error_log2)

PARAMS = dict(n=256, scale_bits=26, num_scaling=28, dnum=4, seed=7,
              secret_hw=8)
BOOT = dict(level_budget=(2, 2), K=8, sin_degree=119, double_angles=1)
WIDE = dict(BOOT, wide=True, scale_boost=4)


@pytest.fixture(scope="module")
def env():
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**PARAMS))
    rots = JBootstrapper.rotations_for(jctx.cfg.n, JBootConfig(**BOOT))
    jkeys = jgenerate_keys(jctx, rotations=rots, conj=True)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    a = np.asarray
    keys = convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a)))
    ev = Evaluator(ctx, keys)
    return JEvaluator(jctx, jkeys), ev, {
        "narrow": Bootstrapper(ev, BootConfig(**BOOT)),
        "wide": Bootstrapper(ev, BootConfig(**WIDE))}


def _port_ct(ev, jct):
    return convert.ciphertext_from_numpy(ev.ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def _assert_same(ct, jct):
    assert (ct.nl, ct.scale) == (jct.nl, jct.scale)
    c0, c1, _, _ = convert.ciphertext_to_numpy(ct)
    np.testing.assert_array_equal(c0, np.asarray(jct.c0))
    np.testing.assert_array_equal(c1, np.asarray(jct.c1))


def _jct(jev, nl, seed, batch=None, scale=None, lim=0.9):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-lim, lim, (batch or 1, jev.ctx.cfg.slots))
    return jev.encrypt(z if batch else z[0], nl=nl, batch=bool(batch),
                       scale=scale)


# -- the transform plan (host numpy) ------------------------------------------


def _same_sparse(a, b):
    assert a.shape == b.shape
    assert abs(a - b).max() == 0


@pytest.mark.parametrize("n,budget", [(256, (2, 2)), (1 << 12, (3, 3))])
def test_transform_plan_matches(n, budget):
    """Stages, groups and generalized diagonals equal the JAX package's,
    keys in the same order (measured 0.1 s and 0.8 s)."""
    jP, jfwd = jtf.special_fft_stages(n)
    P, fwd = tf.special_fft_stages(n)
    _same_sparse(P, jP)
    for s, js in zip(fwd, jfwd, strict=True):
        _same_sparse(s, js)
    inv, jinv = tf.special_ifft_stages(n), jtf.special_ifft_stages(n)
    for s, js in zip(inv, jinv, strict=True):
        _same_sparse(s, js)
    for mats, jmats, b in ((inv[:-1], jinv[:-1], budget[0]),
                           (fwd, jfwd, budget[1])):
        for g, jg in zip(tf.group_stages(mats, b),
                         jtf.group_stages(jmats, b), strict=True):
            _same_sparse(g, jg)
            d, jd = tf.diagonals_of(g), jtf.diagonals_of(jg)
            assert list(d) == list(jd)
            for k in d:
                np.testing.assert_array_equal(d[k], jd[k])
    cfg = dict(level_budget=budget, K=8, sin_degree=119, double_angles=1)
    plan = Bootstrapper._transform_plan(n, BootConfig(**cfg))
    jplan = JBootstrapper._transform_plan(n, JBootConfig(**cfg))
    assert plan[2] == jplan[2]
    assert [list(d) for d in plan[0] + plan[1]] == \
        [list(d) for d in jplan[0] + jplan[1]]


def test_rotations_for_production():
    """The production plan at 2^15 (wide_production): the rotation keys
    the JAX package generates, bs 8, diagonals [32, 63, 31] / [63, 63, 16]
    (measured 7 s, 4 s of it the JAX package's)."""
    cfg = BootConfig.wide_production()
    rots = Bootstrapper.rotations_for(1 << 15, cfg)
    assert rots == JBootstrapper.rotations_for(
        1 << 15, JBootConfig(wide=True, scale_boost=2))
    assert len(rots) == 46
    cts, stc, bs = Bootstrapper._transform_plan(1 << 15, cfg)
    assert bs == 8
    assert [len(d) for d in cts] == [32, 63, 31]
    assert [len(d) for d in stc] == [63, 63, 16]


# -- the wide pieces ----------------------------------------------------------


@pytest.mark.parametrize("node", ["mul_double_sub", "square_double_minus_one"])
def test_wide_node_bit_exact(env, node):
    """The paired-scale Chebyshev nodes (two product rescales; measured
    16 s and 8 s, mostly the JAX package's XLA compiles)."""
    jev, ev, _ = env
    d2 = jev.ctx.delta ** 2
    a = _jct(jev, 12, 1, batch=2, scale=d2)
    if node == "mul_double_sub":
        b = _jct(jev, 12, 2, batch=2, scale=d2)
        c = _jct(jev, 11, 3, batch=2, scale=d2)
        jout = jev.mul_double_sub(a, b, c, wide=True)
        out = ev.mul_double_sub(_port_ct(ev, a), _port_ct(ev, b),
                                _port_ct(ev, c), wide=True)
    else:
        jout = jev.square_double_minus_one(a, wide=True)
        out = ev.square_double_minus_one(_port_ct(ev, a), wide=True)
    assert out.nl == 10
    _assert_same(out, jout)


def test_poly_wide_chebyshev_bit_exact(env):
    """PolyEvaluator(wide=True).eval_chebyshev_series: paired products,
    the 1.5-bit drift clamp, anchor-scale matching (degree 5; measured
    20 s, mostly XLA compiles)."""
    jev, ev, _ = env
    coeffs = chebyshev_fit(np.sin, -1.0, 1.0, 5)
    jct = _jct(jev, 20, 4, scale=jev.ctx.delta ** 2, lim=0.8)
    jout = JPolyEvaluator(jev, wide=True).eval_chebyshev_series(jct, coeffs)
    out = PolyEvaluator(ev, wide=True).eval_chebyshev_series(
        _port_ct(ev, jct), coeffs)
    _assert_same(out, jout)
    got = np.real(ev.decrypt(out))
    want = np.sin(np.real(ev.decrypt(_port_ct(ev, jct))))
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_chebyshev_series_frees_its_basis(env, wide):
    """eval_chebyshev_series leaves no reference cycle behind: its power
    basis is freed when it returns, not at the garbage collector's next
    full pass (a recursive closure over the basis kept config 5's
    128-ciphertext GELU bases on the card between layers)."""
    import gc
    _, ev, _ = env
    z = np.random.default_rng(5).uniform(-0.8, 0.8, ev.ctx.cfg.slots)
    ct = ev.encrypt(z, nl=20)
    coeffs = chebyshev_fit(np.sin, -1.0, 1.0, 13)
    gc.collect()
    gc.disable()
    try:
        out = PolyEvaluator(ev, wide=wide).eval_chebyshev_series(ct, coeffs)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        left = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert left == []
    np.testing.assert_allclose(np.real(ev.decrypt(out)), np.sin(z), atol=1e-2)


@pytest.mark.parametrize("mode", ["single", "double", "raise", "lower"])
def test_bsgs_diag_transform_modes_bit_exact(env, mode):
    """The BSGS transform's four rescale modes on complex diagonals, with
    (nl, scale) set as the JAX package sets them (measured 17 s for the
    first, with the combo's XLA compiles, then 0.3-2 s)."""
    jev, ev, _ = env
    slots = ev.ctx.cfg.slots
    rng = np.random.default_rng(5)
    diags = {k: rng.normal(0, 0.3, slots) + 1j * rng.normal(0, 0.3, slots)
             for k in (0, 1, 2, 5, 8, 13, 16, 40)}
    scale = jev.ctx.delta ** 2 if mode == "lower" else None
    jct = _jct(jev, 10, 6, batch=2, scale=scale)
    jout = JPackedOps(jev, d=1).bsgs_diag_transform(jct, diags, 4,
                                                    rescale_mode=mode)
    out = PackedOps(ev, d=1).bsgs_diag_transform(_port_ct(ev, jct), diags, 4,
                                                 rescale_mode=mode)
    assert out.nl == jct.nl - (1 if mode in ("single", "raise") else 2)
    _assert_same(out, jout)


def test_mod_raise_bit_exact(env):
    """Limb 0's centered lift onto the whole chain, from a batch of
    ciphertexts dropped to one limb (the slice of the full chain;
    measured 3 s)."""
    jev, ev, boots = env
    jct = _jct(jev, None, 7, batch=2)
    jout = JBootstrapper(jev, JBootConfig(**BOOT)).mod_raise(
        jev.drop_to(jct, 1))
    _assert_same(boots["narrow"].mod_raise(_port_ct(ev, jct)), jout)


def test_plaintexts_at_2_52(env):
    """Coefficients far beyond 2^31 (the paired scale qd*qd2 ~ 2^52):
    the coefficient plaintext, its spread over a level's Q basis, the
    EvalMod pre-factor's batch encode and a constant (measured 1 s)."""
    jev, ev, _ = env
    ctx, jctx = ev.ctx, jev.ctx
    nl = 20
    s52 = float(ctx.qs[nl - 1]) * float(ctx.qs[nl - 2])
    rng = np.random.default_rng(8)
    z = rng.normal(0, 0.4, ctx.cfg.slots) + 1j * rng.normal(0, 0.4,
                                                            ctx.cfg.slots)
    jcp = jev.encode_coeff_cached("z", z, scale=s52)
    cp = ev.encode_coeff_cached("z", z, scale=s52)
    coeffs = cp.coeffs.numpy()
    assert np.abs(coeffs).max() > 1 << 40
    np.testing.assert_array_equal(
        coeffs, np.asarray(jcp.hi).astype(np.int64) * (1 << 32) +
        np.asarray(jcp.lo).astype(np.int64))
    jks = jctx.ks_tables(nl)
    np.testing.assert_array_equal(
        ev._pt_expand_q(cp, ctx.ks_tables(nl)).data.numpy().astype(np.uint32),
        np.asarray(jevm._pt_expand_q(jcp.lo, jcp.hi, jks)))
    rows = np.stack([np.full(ctx.cfg.slots, 0.5 / 8),
                     np.full(ctx.cfg.slots, -0.5j / 8)])
    np.testing.assert_array_equal(
        ev.encode(rows, nl=nl, batch=True, scale=s52).data.numpy()
        .astype(np.uint32),
        np.asarray(jev.encode(rows, nl=nl, batch=True, scale=s52).data))
    np.testing.assert_array_equal(
        ev.encode_const(-0.731, nl=nl, scale=s52).data.numpy()
        .astype(np.uint32),
        np.asarray(jev.encode_const(-0.731, nl=nl, scale=s52).data))


# -- the port's whole bootstrap -----------------------------------------------


@pytest.mark.parametrize("kind,floor", [("narrow", 5.5), ("wide", 8.5)])
def test_bootstrap_refreshes(env, kind, floor):
    """The port's bootstrap of a depleted ciphertext: the JAX tests'
    precision floor against the message, its output against simulate(),
    and the counter (measured 2 s each)."""
    jev, ev, boots = env
    booter = boots[kind]
    m = np.random.default_rng(3).uniform(-0.9, 0.9, ev.ctx.cfg.slots)
    low = ev.drop_to(ev.encrypt(m), 1)
    before = GLOBAL_TIMERS.counts["bootstrap"]
    out = booter.bootstrap(low)
    assert GLOBAL_TIMERS.counts["bootstrap"] == before + 1
    assert out.nl == (11 if kind == "narrow" else 3)
    got = np.real(ev.decrypt(out))
    prec = approx_error_log2(m, got)
    assert prec > floor, f"{kind} bootstrap precision {prec} bits"
    boosted = ev.mul_scalar_int(low, booter.cfg.scale_boost)
    boosted.scale = low.scale * booter.cfg.scale_boost
    sim = booter.simulate(ev.decrypt(booter.mod_raise(boosted)),
                          boosted.scale)
    assert approx_error_log2(np.real(sim), got) > floor


def test_bootstrap2_gains(env):
    """Two iterations beat one pass by more than a bit; the output
    (nl, scale) equals one bootstrap's (measured 5 s)."""
    _, ev, boots = env
    booter = boots["narrow"]
    m = np.random.default_rng(5).uniform(-0.9, 0.9, ev.ctx.cfg.slots)
    low = ev.drop_to(ev.encrypt(m), 1)
    one, two = booter.bootstrap(low), booter.bootstrap2(low)
    assert (two.nl, two.scale) == (one.nl, one.scale)
    p1 = approx_error_log2(m, np.real(ev.decrypt(one)))
    p2 = approx_error_log2(m, np.real(ev.decrypt(two)))
    assert p2 > p1 + 1.0, (p1, p2)


def test_bootstrap_chunked_equals_unchunked(env):
    """chunk = 2 on a batch of 3 (two parts, the second zero-padded) gives
    the same residues as one batch-3 bootstrap, and counts 3 (measured
    9 s)."""
    _, ev, boots = env
    booter = boots["narrow"]
    m = np.random.default_rng(9).uniform(-0.9, 0.9, (3, ev.ctx.cfg.slots))
    low = ev.drop_to(ev.encrypt(m, batch=True), 1)
    full = booter.bootstrap(low)
    booter.chunk = 2
    try:
        before = GLOBAL_TIMERS.counts["bootstrap"]
        chunked = booter.bootstrap(low)
        assert GLOBAL_TIMERS.counts["bootstrap"] == before + 3
    finally:
        booter.chunk = 0
    assert (chunked.nl, chunked.scale) == (full.nl, full.scale)
    assert torch.equal(chunked.c0, full.c0) and torch.equal(chunked.c1,
                                                            full.c1)
    np.testing.assert_allclose(np.real(ev.decrypt(chunked)), m, atol=2e-2)


def test_bootstrap_chunks_a_2d_batch(env):
    """A (2, 2) batch with chunk = 3 runs flattened, in a full part and a
    zero-padded one, and equals the unchunked (2, 2) bootstrap."""
    _, ev, boots = env
    booter = boots["narrow"]
    m = np.random.default_rng(10).uniform(-0.9, 0.9, (2, 2, ev.ctx.cfg.slots))
    low = ev.drop_to(ev.encrypt(m.reshape(4, -1), batch=True), 1)
    low = low.with_data(low.c0.reshape((2, 2) + tuple(low.c0.shape[1:])),
                        low.c1.reshape((2, 2) + tuple(low.c1.shape[1:])))
    full = booter.bootstrap(low)
    booter.chunk = 3
    try:
        chunked = booter.bootstrap(low)
    finally:
        booter.chunk = 0
    assert chunked.c0.shape == full.c0.shape == (2, 2, full.nl,
                                                 ev.ctx.cfg.n)
    assert torch.equal(chunked.c0, full.c0) and torch.equal(chunked.c1,
                                                            full.c1)


def test_wide_production_config():
    """wide_production's defaults are the JAX package's with its
    environment knobs unset; refresh runs one pass when wide (measured
    under 0.01 s)."""
    cfg = BootConfig.wide_production()
    j = JBootConfig(wide=True, scale_boost=2)
    assert (cfg.wide, cfg.scale_boost, cfg.wide_early, cfg.out_boost,
            cfg.msg_bound) == (j.wide, j.scale_boost, j.wide_early,
                               j.out_boost, j.msg_bound)
    assert BootConfig.wide_production(scale_boost=4).scale_boost == 4
    assert math.isclose(cfg.msg_bound, 2.0)


# -- slow: the whole bootstrap against the JAX package ------------------------


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_bootstrap_bit_exact_vs_jax(env, kind):
    """The whole bootstrap from the same JAX-made depleted ciphertext:
    equal residues and (nl, scale).  Measured 84 s (narrow) and 92 s
    (wide) with three workers, nearly all of it the JAX package's XLA
    compiles; the port's part takes 2-3 s."""
    jev, ev, boots = env
    m = np.random.default_rng(3).uniform(-0.9, 0.9, ev.ctx.cfg.slots)
    jlow = jev.drop_to(jev.encrypt(m), 1)
    jout = JBootstrapper(jev, JBootConfig(**(WIDE if kind == "wide"
                                             else BOOT))).bootstrap(jlow)
    _assert_same(boots[kind].bootstrap(_port_ct(ev, jlow)), jout)


@pytest.mark.slow
def test_production_bootstrap_levels_vs_jax(monkeypatch):
    """The production bootstrap's level accounting: the linformer-boot-w
    chain (59 q-limbs + 20 special, dnum 3, secret_hw 32; each prime is
    1 mod 2^16, so it serves a smaller ring too) at ring 2^12, with
    wide_production(scale_boost=4), from one JAX-made ciphertext dropped
    to one limb.  Equal residues and (nl, scale), 24 limbs out (the
    current fused Chebyshev nodes leave one level more than the 23 of the
    JAX package's older production record) and at least 6.5 bits.
    Measured 376 s on one worker, most of it the JAX package's."""
    from fhe_linformer_tpu.ckks import context as jcm
    from fhe_linformer_tpu_torch.ckks import context as pcm
    p15 = dict(n=1 << 15, scale_bits=26, num_scaling=58, dnum=3,
               secret_hw=32)
    chain = pcm.modulus_chain(CKKSConfig(**p15))
    assert chain == jcm.modulus_chain(JConfig(**p15))
    monkeypatch.setattr(jcm, "modulus_chain", lambda cfg: chain)
    monkeypatch.setattr(pcm, "modulus_chain", lambda cfg: chain)
    params = dict(p15, n=1 << 12)
    jctx = JContext(JConfig(**params))
    jcfg = JBootConfig(wide=True, scale_boost=4)
    jkeys = jgenerate_keys(jctx, rotations=JBootstrapper.rotations_for(
        params["n"], jcfg), conj=True)
    jev = JEvaluator(jctx, jkeys)
    ctx = Context(CKKSConfig(**params), device="cpu")
    a = np.asarray
    ev = Evaluator(ctx, convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a))))
    m = np.random.default_rng(3).uniform(-0.9, 0.9, ctx.cfg.slots)
    jlow = jev.drop_to(jev.encrypt(m), 1)
    jout = JBootstrapper(jev, jcfg).bootstrap(jlow)
    out = Bootstrapper(ev, BootConfig.wide_production(scale_boost=4)
                       ).bootstrap(_port_ct(ev, jlow))
    _assert_same(out, jout)
    assert out.nl == 24
    assert approx_error_log2(m, np.real(ev.decrypt(out))) >= 6.5
