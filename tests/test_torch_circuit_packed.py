"""The port's block-major Linformer circuit against the JAX package and the
plaintext golden model, at the JAX package's own tiny parameterization
(tests/test_circuit_packed.py: d = 8, k_lin = 4, slots = 128, nb = 16
tokens per ciphertext, num_scaling 58, no bootstrap).

  * BlockOps.matmul on a JAX-made ciphertext: bit-exact vs JAX
  * one degree-13 GELU gadget and the ReLU gadget (degree 13 at two
    scales; degree 119 `slow`): bit-exact vs JAX
  * the port's whole PackedLinformer.forward: logits vs golden
  * the bootstrapped forward (forward(emb, boot=...)) at the JAX test's
    own boot configuration (tests/test_circuit_packed.py: 34 scaling limbs,
    budget (2, 2), K = 8, sine degree 59, input at 12 limbs): logits vs
    golden, with the bootstrap counter showing the hooks fired
  * (slow) the whole forward, and the whole bootstrapped forward, from the
    same JAX-encrypted inputs: bit-exact vs the JAX forward
"""

from dataclasses import fields

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.boot.bootstrap import BootConfig as JBootConfig
from fhe_linformer_tpu.boot.bootstrap import Bootstrapper as JBootstrapper
from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.linalg.blockmat import BlockOps as JBlockOps
from fhe_linformer_tpu.models import golden as jgolden
from fhe_linformer_tpu.models.circuit import CircuitParams as JParams
from fhe_linformer_tpu.models.circuit_packed import (
    PackedLinformer as JPackedLinformer)
from fhe_linformer_tpu.poly.gadgets import Gadgets as JGadgets
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.linalg.blockmat import BlockOps
from fhe_linformer_tpu_torch.models import golden
from fhe_linformer_tpu_torch.models.circuit import CircuitParams
from fhe_linformer_tpu_torch.models.circuit_packed import PackedLinformer
from fhe_linformer_tpu_torch.poly.gadgets import Gadgets
from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS

PARAMS = dict(n=256, scale_bits=26, num_scaling=58, dnum=8, seed=99)
D, KLIN, FFN, NCLS = 8, 4, 32, 5
BS = 4


BOOT_PARAMS = dict(n=256, scale_bits=26, num_scaling=34, dnum=4, seed=23,
                   secret_hw=8)
BOOT = dict(level_budget=(2, 2), K=8, sin_degree=59, double_angles=1)


def _rotations(slots, extra=()):
    pow2, s = [], 1
    while s < slots:
        pow2 += [s, -s]
        s *= 2
    rots = pow2 + [j for j in range(1, BS) if j & (j - 1)]
    return tuple(sorted(set(rots) | set(extra)))


def _env(params, rotations=None, conj=False):
    """JAX keys and evaluator, the port's evaluator on the same keys."""
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**params))
    jkeys = jgenerate_keys(jctx, rotations=rotations or
                           _rotations(jctx.cfg.slots), conj=conj)
    jev = JEvaluator(jctx, jkeys)
    ctx = Context(CKKSConfig(**params), device="cpu")
    a = np.asarray
    keys = convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a)) if conj else None)
    return jev, Evaluator(ctx, keys)


def _weights(max_seq):
    jw = jgolden.random_weights(d=D, k_lin=KLIN, d_ffn=FFN, n_classes=NCLS,
                                max_seq=max_seq, seed=5, scale=0.35)
    return convert.weights_from_numpy(
        {f.name: np.asarray(getattr(jw, f.name)) for f in fields(jw)})


@pytest.fixture(scope="module")
def env():
    return _env(PARAMS) + (_weights(40),)


@pytest.fixture(scope="module")
def boot_env():
    """The JAX bootstrapped-forward test's chain, keys (circuit rotations,
    the bootstrap's, conjugation) and weights."""
    rots = JBootstrapper.rotations_for(BOOT_PARAMS["n"], JBootConfig(**BOOT))
    jev, ev = _env(BOOT_PARAMS, _rotations(BOOT_PARAMS["n"] // 2, rots),
                   conj=True)
    return jev, ev, _weights(12)


def _port_ct(ev, jct):
    return convert.ciphertext_from_numpy(ev.ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def _assert_same(ct, jct):
    assert (ct.nl, ct.scale) == (jct.nl, jct.scale)
    c0, c1, _, _ = convert.ciphertext_to_numpy(ct)
    np.testing.assert_array_equal(c0, np.asarray(jct.c0))
    np.testing.assert_array_equal(c1, np.asarray(jct.c1))


def test_block_matmul_bit_exact(env):
    jev, ev, _ = env
    jb, pb = JBlockOps(jev, D, bs=BS), BlockOps(ev, D, bs=BS)
    rng = np.random.default_rng(0)
    X = rng.normal(0, 0.5, (jb.nb, D))
    W = rng.normal(0, 0.4, (D, D))
    b = rng.normal(0, 0.2, D)
    jct = jev.encrypt(jb.pack(X))
    jout = jb.matmul(jct, W, "t", bias=b)
    out = pb.matmul(_port_ct(ev, jct), W, "t", bias=b)
    _assert_same(out, jout)
    got = pb.unpack(np.real(ev.decrypt(out)), pb.nb)
    np.testing.assert_allclose(got, X @ W.T + b[None], atol=2e-2)


def test_gelu_gadget_bit_exact(env):
    jev, ev, _ = env
    rng = np.random.default_rng(1)
    z = rng.uniform(-0.9, 0.9, (2, jev.ctx.cfg.slots))
    jct = jev.encrypt(z, batch=True, nl=20)
    jout = JGadgets(jev).eval_gelu(jct, -1.0, 1.0, mult=0.5, degree=13)
    out = Gadgets(ev).eval_gelu(_port_ct(ev, jct), -1.0, 1.0, mult=0.5,
                                degree=13)
    _assert_same(out, jout)


@pytest.mark.parametrize("scale,degree", [
    (1.0, 13), (4.0, 13),
    # the JAX package's XLA compiles of the degree-119 evaluation take
    # ~90 s on a CPU
    pytest.param(1.0, 119, marks=pytest.mark.slow)])
def test_relu_gadget_bit_exact(env, scale, degree):
    """Gadgets.relu (relinearisation key only) from a JAX-made ciphertext;
    at degree 13 it runs the GELU gadget's op sequence above, so it reuses
    the JAX package's compiles."""
    jev, ev, _ = env
    z = np.random.default_rng(3).uniform(-1, 1, (2, jev.ctx.cfg.slots))
    jct = jev.encrypt(z, batch=True, nl=20)
    jout = JGadgets(jev).relu(jct, scale=scale, degree=degree)
    out = Gadgets(ev).relu(_port_ct(ev, jct), scale=scale, degree=degree)
    _assert_same(out, jout)


def _calibrated(w, emb):
    """The JAX package's test calibration (tests/test_circuit_packed.py)."""
    _, inter = golden.forward(w, emb, return_intermediates=True)
    rowsum = inter["exp"].sum(-1)
    h_in = inter["norm1"] @ w.W1.T + w.B1[None]
    p_in = inter["norm2"][:1] @ w.Wp.T + w.bp[None]
    return dict(inv_range=(0.8 * rowsum.min(), 1.25 * rowsum.max()),
                inv_degree=27, gelu_clip=1.0 / (1.15 * np.abs(h_in).max()),
                gelu_degree=27, tanh_scale=1.0 / (1.15 * np.abs(p_in).max()),
                tanh_degree=27)


@pytest.mark.parametrize("S", [6, 20], ids=["one_chunk", "two_chunks"])
def test_packed_forward_matches_golden(env, S):
    """S = 20 > nb = 16 runs the attention's chunk loop."""
    _, ev, w = env
    emb = np.random.default_rng(11 + S).normal(0, 0.3, (S - 1, D))
    circ = PackedLinformer(ev, w, CircuitParams(**_calibrated(w, emb)), bs=BS)
    logits = circ.decrypt_logits(circ.forward(emb))
    want = golden.forward(w, emb, return_intermediates=True)[1]["logits"]
    assert np.argmax(logits) == np.argmax(want), (logits, want)
    np.testing.assert_allclose(logits, want, atol=0.05, rtol=0.05)


@pytest.mark.slow
def test_packed_forward_bit_exact_vs_jax(env):
    """The whole layer + pooler/classifier from the same JAX-encrypted
    inputs, against the JAX forward (minutes of XLA compiles)."""
    jev, ev, w = env
    emb = np.random.default_rng(17).normal(0, 0.3, (5, D))
    kw = _calibrated(w, emb)
    jcirc = JPackedLinformer(jev, w, JParams(**kw), bs=BS)
    circ = PackedLinformer(ev, w, CircuitParams(**kw), bs=BS)
    jx, jxe, jxf, S_total = jcirc.encrypt_inputs(emb)
    jout = jcirc.pooler_classifier(jcirc.encoder_layer(jx, jxe, jxf, S_total))
    out = circ.pooler_classifier(circ.encoder_layer(
        _port_ct(ev, jx), _port_ct(ev, jxe), _port_ct(ev, jxf), S_total))
    _assert_same(out, jout)


def _boot_params(w, emb):
    kw = _calibrated(w, emb)
    kw.update(inv_degree=13, gelu_degree=13, tanh_degree=13)
    return kw


def test_packed_forward_bootstrapped_matches_golden(boot_env):
    """forward(emb, boot=...) from 12 input limbs: the mid-exp, pre-GELU
    and pooler refreshes fire (the narrow config refreshes with
    bootstrap2), and the logits match golden at the JAX test's tolerance
    (measured 13 s)."""
    _, ev, w = boot_env
    emb = np.random.default_rng(17).normal(0, 0.3, (5, D))
    circ = PackedLinformer(ev, w, CircuitParams(**_boot_params(w, emb)),
                           bs=BS)
    booter = Bootstrapper(ev, BootConfig(**BOOT))
    before = GLOBAL_TIMERS.counts["bootstrap"]
    out = circ.forward(emb, boot=booter, input_nl=12)
    assert GLOBAL_TIMERS.counts["bootstrap"] - before >= 3
    logits = circ.decrypt_logits(out)
    want = golden.forward(w, emb, return_intermediates=True)[1]["logits"]
    assert np.all(np.isfinite(logits)), logits
    assert np.argmax(logits) == np.argmax(want), (logits, want)
    np.testing.assert_allclose(logits, want, atol=0.2)


@pytest.mark.slow
def test_packed_forward_bootstrapped_bit_exact_vs_jax(boot_env):
    """The bootstrapped layer + pooler/classifier from the same
    JAX-encrypted 12-limb inputs, against the JAX forward with its own
    bootstrapper (measured 657 s, nearly all of it the JAX package's XLA
    compiles)."""
    jev, ev, w = boot_env
    emb = np.random.default_rng(17).normal(0, 0.3, (5, D))
    kw = _boot_params(w, emb)
    jcirc = JPackedLinformer(jev, w, JParams(**kw), bs=BS)
    circ = PackedLinformer(ev, w, CircuitParams(**kw), bs=BS)
    jb = JBootstrapper(jev, JBootConfig(**BOOT))
    pb = Bootstrapper(ev, BootConfig(**BOOT))
    jx, jxe, jxf, S_total = jcirc.encrypt_inputs(emb, nl=12)
    jout = jcirc.pooler_classifier(
        jcirc.encoder_layer(jx, jxe, jxf, S_total, boot=jb), boot=jb)
    out = circ.pooler_classifier(circ.encoder_layer(
        _port_ct(ev, jx), _port_ct(ev, jxe), _port_ct(ev, jxf), S_total,
        boot=pb), boot=pb)
    _assert_same(out, jout)
