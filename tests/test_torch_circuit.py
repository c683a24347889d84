"""The port's per-token encrypted Linformer (models/circuit.py) against the
JAX package, at the JAX package's own tiny parameterization
(tests/test_circuit_stages.py: n = 256, 24 scaling limbs, dnum 4, d = 8,
k_lin = 4, d_ffn = 32, 5 classes).

  * each stage (attention, full and cls_only; wrap/affine/unwrap; the FFN
    on its container path, and token-chunked; ef_project;
    pooler_classifier), fed the same JAX-encrypted inputs, bit-exact vs the
    JAX stage: residues, (nl, scale) and key-switch counts
  * the port's whole forward (the tiny preset's 58-limb chain): logits vs
    golden
  * two 2-layer forwards on one circuit (a decrypt/re-encrypt refresh in
    place of the bootstrap) equal a fresh circuit's bit for bit
  * (slow) the whole 2-layer bootstrapped forward
    (tests/test_circuit_boot.py's setup), bit-exact vs the JAX forward

The attention, FFN and pooler comparisons are `slow` too: each costs the
JAX package 20-70 s of XLA traces and compiles (one per function, batch
shape and level: ~330 for the attention, each key switch ~2 s), so the
default run keeps the stages that share their compiles (wrap/affine/
unwrap, ef_project) and the port's own forwards.
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
from fhe_linformer_tpu.models import golden as jgolden
from fhe_linformer_tpu.models.circuit import CircuitParams as JParams
from fhe_linformer_tpu.models.circuit import (
    EncryptedLinformer as JEncryptedLinformer)
from fhe_linformer_tpu.utils.timing import GLOBAL_TIMERS as JTIMERS
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.boot.bootstrap import BootConfig, Bootstrapper
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.models import golden
from fhe_linformer_tpu_torch.models.circuit import (CircuitParams,
                                                    EncryptedLinformer)
from fhe_linformer_tpu_torch.utils.timing import GLOBAL_TIMERS

PARAMS = dict(n=256, scale_bits=26, num_scaling=24, dnum=4, seed=42)
TINY = dict(n=256, scale_bits=26, num_scaling=58, dnum=8, seed=20260817)
BOOT_PARAMS = dict(n=256, scale_bits=26, num_scaling=34, dnum=4, seed=21,
                   secret_hw=8)
BOOT = dict(level_budget=(2, 2), K=8, sin_degree=59, double_angles=1)
D, KLIN, FFN, NCLS = 8, 4, 32, 5
S = 5


def _pow2(slots):
    out, s = [], 1
    while s < slots:
        out += [s, -s]
        s *= 2
    return out


def _env(params, rotations, conj=False):
    """JAX keys and evaluator, the port's evaluator on the same keys."""
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**params))
    jkeys = jgenerate_keys(jctx, rotations=tuple(rotations), conj=conj)
    ctx = Context(CKKSConfig(**params), device="cpu")
    a = np.asarray
    keys = convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)),
        {r: (a(k.b), a(k.a)) for r, k in jkeys.rot.items()},
        conj=(a(jkeys.conj.b), a(jkeys.conj.a)) if conj else None)
    return JEvaluator(jctx, jkeys), Evaluator(ctx, keys)


def _weights(max_seq, seed=5, scale=0.35):
    jw = jgolden.random_weights(d=D, k_lin=KLIN, d_ffn=FFN, n_classes=NCLS,
                                max_seq=max_seq, seed=seed, scale=scale)
    return convert.weights_from_numpy(
        {f.name: np.asarray(getattr(jw, f.name)) for f in fields(jw)})


def _params(w, inters):
    """tests/test_circuit_stages.py's calibration, over every layer's
    intermediates."""
    rows = np.concatenate([i["exp"].sum(-1) for i in inters])
    h = max(np.abs(i["norm1"] @ lw.W1.T + lw.B1[None]).max()
            for i, lw in zip(inters, w))
    p = np.abs(inters[-1]["norm2"][:1] @ w[0].Wp.T + w[0].bp[None]).max()
    return dict(inv_range=(0.5 * rows.min(), 1.5 * rows.max()),
                inv_degree=13, gelu_degree=13, tanh_degree=13,
                gelu_clip=1.0 / (1.2 * h), tanh_scale=1.0 / (1.2 * p),
                exp_pow8=False)


@pytest.fixture(scope="module")
def env():
    jev, ev = _env(PARAMS, _pow2(PARAMS["n"] // 2))
    w = _weights(24)
    emb = np.random.default_rng(11).normal(0, 0.3, (S - 1, D))
    kw = _params([w], [golden.forward(w, emb, return_intermediates=True)[1]])
    return (JEncryptedLinformer(jev, w, JParams(**kw)),
            EncryptedLinformer(ev, w, CircuitParams(**kw)), emb)


def _port_ct(circ, jct):
    return convert.ciphertext_from_numpy(circ.ev.ctx, np.asarray(jct.c0),
                                         np.asarray(jct.c1), jct.nl, jct.scale)


def _assert_same(ct, jct):
    assert (ct.nl, ct.scale) == (jct.nl, jct.scale)
    c0, c1, _, _ = convert.ciphertext_to_numpy(ct)
    np.testing.assert_array_equal(c0, np.asarray(jct.c0))
    np.testing.assert_array_equal(c1, np.asarray(jct.c1))


def _both(jrun, run):
    """Runs both stages; asserts equal results and equal key-switch
    counts."""
    k0, jk0 = GLOBAL_TIMERS.counts["keyswitch"], JTIMERS.counts["keyswitch"]
    jout, out = jrun(), run()
    _assert_same(out, jout)
    assert GLOBAL_TIMERS.counts["keyswitch"] - k0 == \
        JTIMERS.counts["keyswitch"] - jk0
    return jout, out


def _enc(jcirc, X, nl=None):
    return jcirc.ev.encrypt(np.stack([jcirc.ops.expanded_slots(r)
                                      for r in np.atleast_2d(X)]),
                            batch=True, nl=nl)


@pytest.mark.slow
@pytest.mark.parametrize("cls_only", [False, True], ids=["full", "cls_only"])
def test_attention_bit_exact(env, cls_only):
    jcirc, circ, emb = env
    jx, jxe, jxf, S_total = jcirc.encrypt_inputs(emb, nl=20)
    args = [_port_ct(circ, c) for c in (jx, jxe, jxf)]
    _both(lambda: jcirc.attention(jx, jxe, jxf, S_total, cls_only),
          lambda: circ.attention(*args, S_total, cls_only))


def test_wrap_affine_unwrap_bit_exact(env):
    jcirc, circ, _ = env
    w = circ.w
    jct = _enc(jcirc, np.random.default_rng(3).normal(0, 0.5, (S, D)), nl=8)
    ct = _port_ct(circ, jct)
    jwr, wr = _both(lambda: jcirc.affine(jcirc.wrap_tokens(jct), w.a1, w.b1,
                                         w.c1, S),
                    lambda: circ.affine(circ.wrap_tokens(ct), w.a1, w.b1,
                                        w.c1, S))
    _both(lambda: jcirc.unwrap_tokens(jwr, S),
          lambda: circ.unwrap_tokens(wr, S))


@pytest.mark.slow
@pytest.mark.parametrize("rows,token_chunk", [(S, None), (18, 8)],
                         ids=["containers", "token_chunk"])
def test_ffn_bit_exact(env, rows, token_chunk):
    """S = 5: 4 blocks x 5 tokens > 16 pieces take the container path;
    18 tokens in chunks of 8 force it on the 2-token remainder too."""
    jcirc, circ, _ = env
    jct = _enc(jcirc, np.random.default_rng(4).normal(0, 0.4, (rows, D)),
               nl=14)
    ct = _port_ct(circ, jct)
    _both(lambda: jcirc.ffn(jct, token_chunk=token_chunk),
          lambda: circ.ffn(ct, token_chunk=token_chunk))


def test_ef_project_bit_exact(env):
    jcirc, circ, _ = env
    rng = np.random.default_rng(8)
    jct = _enc(jcirc, rng.normal(0, 0.5, (S, D)), nl=8)
    E = rng.normal(0, 0.4, (KLIN, S))
    b = rng.normal(0, 0.2, KLIN)
    _, out = _both(lambda: jcirc.ef_project(jct, E, b, S),
                   lambda: circ.ef_project(_port_ct(circ, jct), E, b, S))
    X = np.real(circ.ev.decrypt(_port_ct(circ, jct)))[:, ::D][:, :D]
    got = np.real(circ.ev.decrypt(out))[:, ::D][:, :D]
    np.testing.assert_allclose(got, E @ X + b[:, None], atol=5e-3)


@pytest.mark.slow
def test_pooler_classifier_bit_exact(env):
    jcirc, circ, _ = env
    jct = _enc(jcirc, np.random.default_rng(9).normal(0, 0.5, (1, D)), nl=12)
    one = jct.with_data(jct.c0[0], jct.c1[0])
    _both(lambda: jcirc.pooler_classifier(one),
          lambda: circ.pooler_classifier(_port_ct(circ, one)))


def test_forward_matches_golden():
    """The port alone, on the tiny preset's chain with its own keys:
    encrypt -> layer -> pooler/classifier -> decrypt, against golden."""
    torch.set_num_threads(2)
    ctx = Context(CKKSConfig(**TINY), device="cpu")
    ev = Evaluator(ctx, generate_keys(ctx, rotations=_pow2(ctx.cfg.slots)))
    w = _weights(12, seed=6)
    emb = np.random.default_rng(12).normal(0, 0.3, (S - 1, D))
    want = golden.forward(w, emb, return_intermediates=True)[1]
    circ = EncryptedLinformer(ev, w, CircuitParams(**_params([w], [want])))
    logits = circ.decrypt_logits(circ.forward(emb))
    assert np.argmax(logits) == np.argmax(want["logits"]), (logits, want)
    np.testing.assert_allclose(logits, want["logits"], atol=0.05)


def test_weight_plaintexts_cached_per_weights(env):
    """_pt keys by the weights as well as (name, level): the same weights
    hit their entry; another layer's weights at the same (name, level)
    get a plaintext of their own."""
    _, circ, _ = env
    w1, w2 = circ.w, _weights(24, seed=6, scale=0.3)

    def probe(w):
        return circ._pt("probe", circ.ops.matrix_re_slots(w.W1[:D]), 8)

    a = probe(w1)
    assert probe(w1) is a
    circ.w = w2
    try:
        b = probe(w2)
    finally:
        circ.w = w1
    assert b is not a and not torch.equal(a.data, b.data)
    assert probe(w1) is a


class _ClientRefresh:
    """A stand-in for the bootstrapper: decrypt, re-encrypt at `nl` limbs.
    Like a bootstrap it leaves every refresh at one (nl, scale), so both
    layers' FFNs start from the same level."""

    def __init__(self, ev, nl):
        self.ev, self.nl = ev, nl

    def refresh(self, ct):
        vals = self.ev.decrypt(ct)
        lead = vals.shape[:-1]
        out = self.ev.encrypt(vals.reshape((-1, vals.shape[-1])), batch=True,
                              nl=self.nl)
        return out.with_data(out.c0.reshape(lead + tuple(out.c0.shape[1:])),
                             out.c1.reshape(lead + tuple(out.c1.shape[1:])))

    bootstrap = refresh


def test_forward_twice_equals_fresh_circuit():
    """A second forward(extra_layers=) request on one circuit gives the
    first's ciphertext (a fresh circuit's) bit for bit on the same
    encryption draws.  The plaintext cache must tell the layers' weights
    apart: keyed by name and level alone, the second request's layer 1
    found layer 2's FFN plaintexts at the refresh's level."""
    torch.set_num_threads(2)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    keys = generate_keys(ctx, rotations=_pow2(ctx.cfg.slots))
    w1, w2 = _weights(12), _weights(12, seed=6, scale=0.3)
    emb = np.random.default_rng(13).normal(0, 0.3, (4, D))
    i1 = golden.forward(w1, emb, return_intermediates=True)[1]
    i2 = golden.forward(w1, emb, extra_layers=[w2],
                        return_intermediates=True)[1]
    p = CircuitParams(**_params([w1, w2], [i1, i2]))

    def request(circ):
        circ.ev._enc_rng = np.random.default_rng(ctx.cfg.seed ^ 0x5EED)
        return circ.forward(emb, extra_layers=[w2], input_nl=10,
                            boot=_ClientRefresh(circ.ev, 16))

    circ = EncryptedLinformer(Evaluator(ctx, keys), w1, p)
    fresh, second = request(circ), request(circ)
    assert (second.nl, second.scale) == (fresh.nl, fresh.scale)
    assert torch.equal(second.c0, fresh.c0)
    assert torch.equal(second.c1, fresh.c1)
    logits = circ.decrypt_logits(second)
    assert np.argmax(logits) == np.argmax(i2["logits"]), (logits, i2)
    np.testing.assert_allclose(logits, i2["logits"], atol=0.05)


@pytest.mark.slow
def test_two_layer_bootstrapped_forward_bit_exact_vs_jax():
    """Config 5 at n = 256 (tests/test_circuit_boot.py's setup): two
    layers, the second's E/F compression homomorphic, refreshes between
    segments, from the same JAX-encrypted 10-limb inputs; then the decrypt
    against the 2-layer golden."""
    rots = set(JBootstrapper.rotations_for(BOOT_PARAMS["n"],
                                           JBootConfig(**BOOT)))
    rots |= set(_pow2(BOOT_PARAMS["n"] // 2))
    jev, ev = _env(BOOT_PARAMS, sorted(rots), conj=True)
    w1, w2 = _weights(12), _weights(12, seed=6, scale=0.3)
    emb = np.random.default_rng(13).normal(0, 0.3, (4, D))
    i1 = golden.forward(w1, emb, return_intermediates=True)[1]
    i2 = golden.forward(w1, emb, extra_layers=[w2],
                        return_intermediates=True)[1]
    kw = _params([w1, w2], [i1, i2])
    jcirc = JEncryptedLinformer(jev, w1, JParams(**kw))
    circ = EncryptedLinformer(ev, w1, CircuitParams(**kw))
    jb, pb = JBootstrapper(jev, JBootConfig(**BOOT)), \
        Bootstrapper(ev, BootConfig(**BOOT))
    jx, jxe, jxf, S_total = jcirc.encrypt_inputs(emb, nl=10)
    jy = jcirc.encoder_layer(jx, jxe, jxf, S_total, boot=jb)
    y = circ.encoder_layer(*(_port_ct(circ, c) for c in (jx, jxe, jxf)),
                           S_total, boot=pb)
    _assert_same(y, jy)
    # the JAX forward's layer loop: caches cleared before the next layer
    # (its plaintexts are keyed by name and level, not by the weights)
    jev._enc_cache.clear()
    jcirc._pt_cache.clear()
    saved = jcirc.w
    jcirc.w = w2
    jy = jcirc.encoder_layer(
        jy, jcirc.ef_project(jy, w2.E_w[:, :S_total], w2.E_b, S_total),
        jcirc.ef_project(jy, w2.F_w[:, :S_total], w2.F_b, S_total),
        S_total, boot=jb)
    jcirc.w = saved
    y = circ.next_layer(y, w2, S_total, boot=pb)
    _assert_same(y, jy)
    jout = jcirc.pooler_classifier(jy.with_data(jy.c0[0], jy.c1[0]), boot=jb)
    out = circ.pooler_classifier(y.with_data(y.c0[0], y.c1[0]), boot=pb)
    _assert_same(out, jout)
    logits = circ.decrypt_logits(out)
    assert np.argmax(logits) == np.argmax(i2["logits"]), (logits, i2)
    np.testing.assert_allclose(logits, i2["logits"], atol=0.2)
