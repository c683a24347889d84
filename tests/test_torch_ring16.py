"""Preset linformer-128c (ring 2^16, 46 scaling limbs, dnum 3, uniform
ternary secret) in the port against the JAX package.

  * the modulus chain, prime for prime (the sparse 2^17-friendly pool with
    the magnitude-matched interleave), and the context built on it;
  * `security.assess`: log2(QP), the table bound extrapolated past 2^15,
    and the 56.7-bit headroom;
  * key generation's uniform-secret branch: the secret, the public,
    relinearisation and one rotation key equal the JAX keys, on the 128c
    chain at ring 2^12 (its primes are 1 mod 2^17, so they serve the
    smaller ring);
  * (slow) the uniform-secret wide bootstrap (K = 512, degree-201 sine,
    6 double angles, scale_boost 4) at ring 2^12 on the 128c chain from
    one JAX-made ciphertext, bit for bit, with its limbs out.
"""

import numpy as np
import pytest
import torch

from fhe_linformer_tpu import security as jsecurity
from fhe_linformer_tpu.boot.bootstrap import BootConfig as JBootConfig
from fhe_linformer_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import context as jcm
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.config import get as jget
from fhe_linformer_tpu_torch import convert, security
from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
from fhe_linformer_tpu_torch.ckks import context as pcm
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.config import get
from fhe_linformer_tpu_torch.utils.timing import approx_error_log2

# tools/ring128c_run.py's bootstrap
BOOT128C = dict(wide=True, scale_boost=4, K=512, sin_degree=201,
                double_angles=6)
SMALL_N = 1 << 12


def _fields(cfg):
    return {k: getattr(cfg, k) for k in ("n", "scale_bits", "num_scaling",
                                         "first_mod_bits", "dnum",
                                         "secret_hw", "sigma", "seed")}


@pytest.fixture(scope="module")
def chain():
    cfg = get("linformer-128c").ckks
    assert _fields(cfg) == _fields(jget("linformer-128c").ckks)
    return cfg, pcm.modulus_chain(cfg)


def test_128c_chain_matches_jax(chain):
    cfg, (qs, ps, alpha) = chain
    assert (qs, ps, alpha) == jcm.modulus_chain(JConfig(**_fields(cfg)))
    assert (cfg.n, cfg.secret_hw, len(qs), len(ps), alpha) == \
        (1 << 16, None, 47, 16, 16)
    assert all((q - 1) % (2 * cfg.n) == 0 for q in qs + ps)
    ctx = Context(cfg, device="cpu")
    assert (ctx.qs, ctx.ps, ctx.alpha, ctx.num_q, ctx.k_sp) == \
        (qs, ps, alpha, 47, 16)
    assert ctx.ntt.n == 1 << 16 and ctx.ntt.logn == 16


def test_128c_security_matches_jax(chain):
    cfg, _ = chain
    got = security.assess(cfg)
    want = jsecurity.assess(JConfig(**_fields(cfg)))
    assert got.__dict__ == want.__dict__
    assert got.classical_bits == 128 and not got.sparse_secret
    assert got.headroom_bits == pytest.approx(56.684045728495676, abs=1e-9)
    assert security.max_log_qp(cfg.n) == jsecurity.max_log_qp(cfg.n) == \
        2 * 881


@pytest.fixture(scope="module")
def small(chain):
    """The 128c chain at ring 2^12: the JAX and the port's contexts."""
    cfg, qs_ps = chain
    mp = pytest.MonkeyPatch()
    mp.setattr(jcm, "modulus_chain", lambda c: qs_ps)
    mp.setattr(pcm, "modulus_chain", lambda c: qs_ps)
    params = dict(_fields(cfg), n=SMALL_N)
    torch.set_num_threads(2)
    try:
        yield JContext(JConfig(**params)), Context(CKKSConfig(**params),
                                                   device="cpu")
    finally:
        mp.undo()


def test_uniform_secret_keys_match_jax(small):
    """secret_hw=None draws rng.integers(-1, 2, n): a dense ternary secret.
    The port's draws follow the JAX package's, key for key."""
    jctx, ctx = small
    jk = jgenerate_keys(jctx, rotations=(1,))
    keys = generate_keys(ctx, rotations=(1,))
    s = keys.sk.coeffs
    np.testing.assert_array_equal(s, jk.sk.coeffs)
    assert set(np.unique(s)) == {-1, 0, 1}
    assert np.count_nonzero(s) > SMALL_N // 2       # not sparse
    assert keys.sk.eval_full.shape == (47 + 16, SMALL_N)
    pairs = [(keys.sk.eval_full, jk.sk.eval_full), (keys.pk.p0, jk.pk.p0),
             (keys.pk.p1, jk.pk.p1), (keys.relin.b, jk.relin.b),
             (keys.relin.a, jk.relin.a), (keys.rot[1].b, jk.rot[1].b),
             (keys.rot[1].a, jk.rot[1].a)]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                      np.asarray(want))


@pytest.mark.slow
def test_128c_bootstrap_levels_vs_jax(small):
    """tools/ring128c_run.py's bootstrap at ring 2^12 on the 128c chain,
    from one JAX-made ciphertext dropped to one limb: equal residues and
    (nl, scale), the limbs out that chip_smoke.py's ring16 phase requires
    at 2^16 (the level accounting does not depend on the ring), and at
    least 4 bits.  Most of its minutes are the JAX package's compiles."""
    import chip_smoke
    jctx, ctx = small
    jcfg = JBootConfig(**BOOT128C)
    jkeys = jgenerate_keys(jctx, rotations=JBootstrapper.rotations_for(
        SMALL_N, jcfg), conj=True)
    jev = JEvaluator(jctx, jkeys)
    a = np.asarray
    ev = Evaluator(ctx, convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a))))
    m = np.random.default_rng(3).uniform(-0.9, 0.9, ctx.cfg.slots)
    jlow = jev.drop_to(jev.encrypt(m), 1)
    jout = JBootstrapper(jev, jcfg).bootstrap(jlow)
    out = Bootstrapper(ev, BootConfig(**BOOT128C)).bootstrap(
        convert.ciphertext_from_numpy(ctx, a(jlow.c0), a(jlow.c1), jlow.nl,
                                      jlow.scale))
    assert (out.nl, out.scale) == (jout.nl, jout.scale)
    c0, c1, _, _ = convert.ciphertext_to_numpy(out)
    np.testing.assert_array_equal(c0, a(jout.c0))
    np.testing.assert_array_equal(c1, a(jout.c1))
    assert out.nl == chip_smoke.REFERENCE_RING16["out_nl"]
    assert approx_error_log2(m, np.real(ev.decrypt_host(out))) >= 4.0
