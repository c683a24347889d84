"""The port's keystore, checkpoint, weight-file, client-pipeline and
security modules against the JAX package's, at n = 256.

  * ciphertexts written by either package load in the other and equal what
    it held: the JAX package's "native" sidecar pages (CRC-32 checked) and
    its inline layout, the port's native pages
  * keystores, plain and seed-compressed, both directions, with and
    without reduced-basis keys (KSKey.max_nl); the loaded keys equal the
    port's own generate_keys for the same config
  * reference weights: round trip, the legacy-name fallback, files the JAX
    package wrote and files it reads
  * client pipeline: embedding files, the E/F projection files, softmax
  * security: assess / estimator_input print the JAX strings for every
    preset
"""

import os
import shutil
from dataclasses import fields

import numpy as np
import pytest
import torch

from fhe_linformer_tpu import config as jconfig
from fhe_linformer_tpu import security as jsecurity
from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.client import pipeline as jpipeline
from fhe_linformer_tpu.io import native as jnative
from fhe_linformer_tpu.io import serialize as jser
from fhe_linformer_tpu.io import weights as jweights
from fhe_linformer_tpu.models import golden as jgolden
from fhe_linformer_tpu_torch import config, security
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.keys import generate_keys
from fhe_linformer_tpu_torch.client import pipeline
from fhe_linformer_tpu_torch.io import serialize as ser
from fhe_linformer_tpu_torch.io import weights
from fhe_linformer_tpu_torch.models import golden

PARAMS = dict(n=256, scale_bits=26, num_scaling=6, dnum=2, seed=55)
ROTS = (-2, 1, 4)


@pytest.fixture(scope="module")
def env():
    torch.set_num_threads(2)
    jctx = JContext(JConfig(**PARAMS))
    jkeys = jgenerate_keys(jctx, rotations=ROTS, conj=True)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    return JEvaluator(jctx, jkeys), ctx, generate_keys(ctx, rotations=ROTS,
                                                       conj=True)


def _eq(t, a):
    np.testing.assert_array_equal(t.cpu().numpy().astype(np.uint32),
                                  np.asarray(a))


def _keys_equal(keys, jkeys):
    """A port KeySet against a JAX one, array by array."""
    _eq(keys.pk.p0, jkeys.pk.p0)
    _eq(keys.pk.p1, jkeys.pk.p1)
    pairs = [(keys.relin, jkeys.relin), (keys.conj, jkeys.conj)] + \
        [(keys.rot[r], jkeys.rot[r]) for r in jkeys.rot]
    assert sorted(keys.rot) == sorted(jkeys.rot)
    for k, jk in pairs:
        _eq(k.b, jk.b)
        _eq(k.a, jk.a)
    if jkeys.sk is not None:
        np.testing.assert_array_equal(keys.sk.coeffs, jkeys.sk.coeffs)
        _eq(keys.sk.eval_full, jkeys.sk.eval_full)


@pytest.mark.parametrize("layout", ["native", "inline"])
def test_jax_ciphertext_loads(env, tmp_path, monkeypatch, layout):
    jev, ctx, _ = env
    jct = jev.encrypt(np.random.default_rng(1).uniform(-1, 1, (3, 128)),
                      batch=True, nl=5)
    path = str(tmp_path / "ct.bin")
    if layout == "native":
        if jnative.get_lib() is None:
            pytest.skip("native/fastio.so does not build or load here; the "
                        "inline case covers the format")
    else:
        monkeypatch.setattr(jnative, "write_blob", lambda *a: False)
    jser.save_ciphertext(path, jct)
    assert os.path.exists(path + ".pages") == (layout == "native")
    ct = ser.load_ciphertext(path, ctx)
    assert (ct.nl, ct.scale) == (jct.nl, jct.scale)
    _eq(ct.c0, jct.c0)
    _eq(ct.c1, jct.c1)


def test_native_pages_crc_checked(env, tmp_path):
    jev, ctx, _ = env
    if jnative.get_lib() is None:
        pytest.skip("native/fastio.so does not build or load here")
    path = str(tmp_path / "ct.bin")
    jser.save_ciphertext(path, jev.encrypt(np.zeros(128), nl=3))
    raw = bytearray(open(path + ".pages", "rb").read())
    raw[20] ^= 1
    open(path + ".pages", "wb").write(bytes(raw))
    with pytest.raises(IOError, match="crc"):
        ser.load_ciphertext(path, ctx)


def test_port_ciphertext_loads_in_jax(env, tmp_path):
    """The port writes native CRC-checked pages (io/native.py); the JAX
    package loads them, the plain numpy reader reads the same residues,
    and the port loads its own file back."""
    jev, ctx, keys = env
    from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
    ct = Evaluator(ctx, keys).encrypt(
        np.random.default_rng(2).uniform(-1, 1, (2, 128)), batch=True, nl=4)
    path = str(tmp_path / "ct.bin")
    ser.save_ciphertext(path, ct)
    assert os.path.exists(path + ".pages")
    np.testing.assert_array_equal(
        ser.read_pages(path + ".pages"),
        np.concatenate([ct.c0.numpy().reshape(-1),
                        ct.c1.numpy().reshape(-1)]).astype(np.uint32))
    if jnative.get_lib() is None:
        pytest.skip("native/fastio.so does not build or load here")
    jct = jser.load_ciphertext(path)
    assert (jct.nl, jct.scale) == (ct.nl, ct.scale)
    _eq(ct.c0, jct.c0)
    _eq(ct.c1, jct.c1)
    back = ser.load_ciphertext(path, ctx)
    assert (back.nl, back.scale) == (ct.nl, ct.scale)
    assert torch.equal(back.c0, ct.c0) and torch.equal(back.c1, ct.c1)


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "plain"])
def test_jax_keystore_loads(env, tmp_path, compress):
    """The JAX package's keystore loads in the port and equals both the
    JAX keys and the port's own generate_keys."""
    jev, ctx, keys = env
    d = str(tmp_path / "keys")
    jser.save_keys(d, jev.keys, include_secret=True, compress=compress)
    loaded = ser.load_keys(d, ctx)
    _keys_equal(loaded, jev.keys)
    _keys_equal(keys, jev.keys)
    assert (loaded.relin.a_seed is not None) == compress


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "plain"])
def test_port_keystore_loads_in_jax(env, tmp_path, compress):
    jev, ctx, keys = env
    d = str(tmp_path / "keys")
    ser.save_keys(d, keys, include_secret=False, compress=compress)
    assert ("a_seed" in np.load(os.path.join(d, "relin.npz"))) == compress
    jloaded = jser.load_keys(d, ctx=jev.ctx)
    assert jloaded.sk is None
    _keys_equal(keys, jloaded)


@pytest.fixture(scope="module")
def reduced_env():
    """Keys with reduced-basis rotations (max_nl 4 of 7 q-limbs) made by
    both packages: 1 and -2 full, 2 and -8 reduced, 4 in both sets."""
    kw = dict(rotations=(1, 4, -2), conj=True, rotations_reduced=(2, 4, -8),
              reduced_max_nl=4)
    jctx = JContext(JConfig(**PARAMS))
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    return jctx, jgenerate_keys(jctx, **kw), ctx, generate_keys(ctx, **kw)


def _max_nls(keys):
    return {r: k.max_nl for r, k in keys.rot.items()}


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "plain"])
def test_jax_reduced_keystore_loads(reduced_env, tmp_path, compress):
    """A JAX keystore holding max_nl keys loads in the port: `max_nl`
    carried, `a` regenerated over the key's own rows, keys equal."""
    jctx, jkeys, ctx, keys = reduced_env
    d = str(tmp_path / "keys")
    jser.save_keys(d, jkeys, include_secret=True, compress=compress)
    loaded = ser.load_keys(d, ctx)
    assert _max_nls(loaded) == _max_nls(jkeys) == \
        {1: None, 4: None, -2: None, 2: 4, -8: 4}
    _keys_equal(loaded, jkeys)
    _keys_equal(keys, jkeys)
    assert (loaded.rot[2].a_seed is not None) == compress


@pytest.mark.parametrize("compress", [True, False],
                         ids=["compressed", "plain"])
def test_port_reduced_keystore_loads_in_jax(reduced_env, tmp_path, compress):
    jctx, jkeys, ctx, keys = reduced_env
    d = str(tmp_path / "keys")
    ser.save_keys(d, keys, include_secret=False, compress=compress)
    assert int(np.load(os.path.join(d, "rot_-8.npz"))["max_nl"]) == 4
    jloaded = jser.load_keys(d, ctx=jctx)
    assert _max_nls(jloaded) == _max_nls(keys)
    _keys_equal(keys, jloaded)


def test_reduced_keystore_shape_checked(reduced_env, tmp_path):
    """A reduced key's rows are checked against its own max_nl."""
    jctx, jkeys, ctx, _ = reduced_env
    d = str(tmp_path / "keys")
    jser.save_keys(d, jkeys)
    z = dict(np.load(os.path.join(d, "rot_2.npz")))
    z["max_nl"] = np.asarray(5, np.int64)
    np.savez(os.path.join(d, "rot_2.npz"), **z)
    with pytest.raises(ValueError, match="max_nl 5"):
        ser.load_keys(d, ctx)


def _jw(seed=3):
    return jgolden.random_weights(d=8, k_lin=4, d_ffn=32, n_classes=5,
                                  max_seq=12, seed=seed, scale=0.3)


def _w_equal(w, jw):
    for f in fields(jw):
        np.testing.assert_array_equal(np.asarray(getattr(w, f.name)),
                                      np.asarray(getattr(jw, f.name)))


def test_reference_weights_cross_and_round_trip(tmp_path):
    kw = dict(d=8, k_lin=4, d_ffn=32, n_classes=5, max_seq=12)
    jw = _jw()
    jweights.save_reference_weights(str(tmp_path / "j"), jw)
    _w_equal(weights.load_reference_weights(str(tmp_path / "j"), **kw), jw)
    w = golden.random_weights(**kw, seed=4, scale=0.3)
    weights.save_reference_weights(str(tmp_path / "p"), w)
    for a, b in zip(sorted(os.listdir(tmp_path / "p")),
                    sorted(os.listdir(tmp_path / "j"))):
        assert a == b
    _w_equal(weights.load_reference_weights(str(tmp_path / "p"), **kw),
             jweights.load_reference_weights(str(tmp_path / "p"), **kw))
    _w_equal(weights.load_reference_weights(str(tmp_path / "p"), **kw), w)


def test_reference_weights_legacy_names(tmp_path):
    kw = dict(d=8, k_lin=4, d_ffn=32, n_classes=5, max_seq=12)
    wd = str(tmp_path / "w")
    jweights.save_reference_weights(wd, _jw(5))
    for new, old in weights._LEGACY.items():
        shutil.move(os.path.join(wd, new), os.path.join(wd, old))
    assert weights._LEGACY == jweights._LEGACY
    _w_equal(weights.load_reference_weights(wd, **kw),
             jweights.load_reference_weights(wd, **kw))
    legacy = os.path.join(wd, "linformer_posEmb.txt")
    np.testing.assert_array_equal(weights.read_values(legacy),
                                  jweights.read_values(legacy))


def test_client_pipeline(tmp_path):
    jw = _jw(6)
    w = golden.LinformerWeights(**{f.name: getattr(jw, f.name)
                                   for f in fields(jw)})
    emb = np.random.default_rng(2).normal(0, 0.3, (4, 8))
    pipeline.export_sample_embeddings(str(tmp_path / "p"), emb)
    jpipeline.export_sample_embeddings(str(tmp_path / "j"), emb)
    for f in os.listdir(tmp_path / "j"):
        assert open(tmp_path / "p" / f).read() == \
            open(tmp_path / "j" / f).read()
    np.testing.assert_array_equal(
        pipeline.load_sample_embeddings(str(tmp_path / "j")), emb)
    out = pipeline.project_ef(str(tmp_path / "pe"), w, emb)
    jout = jpipeline.project_ef(str(tmp_path / "je"), jw, emb)
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a, b)
    assert sorted(os.listdir(tmp_path / "pe")) == \
        sorted(os.listdir(tmp_path / "je"))
    logits = np.random.default_rng(3).normal(size=7)
    cls, p = pipeline.softmax_argmax(logits)
    jcls, jp = jpipeline.softmax_argmax(logits)
    assert cls == jcls
    np.testing.assert_array_equal(p, jp)


def test_security_strings_equal_jax():
    assert sorted(config.PRESETS) == sorted(jconfig.PRESETS)
    for name in sorted(config.PRESETS):
        cfg, jcfg = config.get(name).ckks, jconfig.get(name).ckks
        assert str(security.assess(cfg)) == str(jsecurity.assess(jcfg))
        assert security.estimator_input(cfg) == \
            jsecurity.estimator_input(jcfg)
    for n in (1024, 3000, 32768, 1 << 17):
        for lv in (128, 192, 256):
            for model in ("classical", "quantum"):
                assert security.max_log_qp(n, lv, model) == \
                    jsecurity.max_log_qp(n, lv, model)
