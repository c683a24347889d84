"""The port's host codec (fhe_linformer_tpu_torch/io/native.py over
csrc/fastio.cpp, built here by g++) against the JAX package's
io/native.py and against the port's plain versions.

  * the centered CRT lift: bit for bit equal to the JAX package's native
    lifter on uniform residues at 1-4 limbs, equal to the Python-int lift
    on values of decrypt size (and within one ulp of it on uniform
    residues: the C++ conversion rounds twice), the exact path at
    Q >= 2^120
  * checkpoint pages: round trip, the plain numpy reader, the JAX reader,
    a flipped byte and a short file raising
  * read_floats against the JAX package's on a file io/weights writes
  * a failed build raises with the compiler's output; the library is the
    port's own, built into build/torch_kernels
  * the port's decrypt through the native lift equals the JAX package's
    decrypt in float64 on a JAX-made ciphertext
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.ckks import Evaluator as JEvaluator
from fhe_linformer_tpu.ckks import generate_keys as jgenerate_keys
from fhe_linformer_tpu.io import native as jnative
from fhe_linformer_tpu_torch import convert
from fhe_linformer_tpu_torch.ckks.context import CKKSConfig, Context
from fhe_linformer_tpu_torch.ckks.encoding import crt_lift_center as exact_lift
from fhe_linformer_tpu_torch.ckks.evaluator import Evaluator
from fhe_linformer_tpu_torch.io import native, weights
from fhe_linformer_tpu_torch.io.serialize import read_pages
from fhe_linformer_tpu_torch.models import golden
from fhe_linformer_tpu_torch.ops import cuda_build
from fhe_linformer_tpu_torch.primes import ntt_primes

N = 4096


def _jax_lib():
    if jnative.get_lib() is None:
        pytest.skip("native/fastio.so does not build or load here")


@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
def test_lift_bit_exact_vs_jax_native(limbs):
    _jax_lib()
    qs = ntt_primes(2 * N, limbs)
    rng = np.random.default_rng(limbs)
    res = np.stack([rng.integers(0, q, N) for q in qs]).astype(np.uint32)
    got = native.crt_lift_center(res, qs)
    want = jnative.crt_lift_center(res, qs)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    # two roundings against one: at most one ulp from the exact lift
    np.testing.assert_array_max_ulp(got, exact_lift(res, qs), maxulp=1)


@pytest.mark.parametrize("limbs", [1, 2, 3, 4])
def test_lift_equals_python_ints_at_decrypt_size(limbs):
    """Coefficients of a decrypt (scale x message, below 2^53 and Q/2):
    the native and the Python-int lift are equal bit for bit and exact."""
    qs = ntt_primes(2 * N, limbs)
    Q = int(np.prod([int(q) for q in qs], dtype=object))
    bound = min(1 << 52, Q // 2 - 1)
    x = np.random.default_rng(9).integers(-bound, bound, N, dtype=np.int64)
    res = np.stack([x % q for q in qs]).astype(np.uint32)
    got = native.crt_lift_center(res, qs)
    np.testing.assert_array_equal(got.view(np.uint64),
                                  exact_lift(res, qs).view(np.uint64))
    np.testing.assert_array_equal(got, x.astype(np.float64))


def test_lift_exact_path_at_2_120():
    """Five 30-bit limbs (Q >= 2^120) take the exact Python-int path in
    both packages."""
    qs = ntt_primes(2 * N, 5)
    assert np.prod([int(q) for q in qs], dtype=object) >= 1 << 120
    rng = np.random.default_rng(5)
    res = np.stack([rng.integers(0, q, 256) for q in qs]).astype(np.uint32)
    got = native.crt_lift_center(res, qs)
    np.testing.assert_array_equal(got, exact_lift(res, qs))
    np.testing.assert_array_equal(got, jnative.crt_lift_center(res, qs))
    with pytest.raises(ValueError, match="primes"):
        native.crt_lift_center(res[:4], qs)


def test_blob_round_trip_and_crc(tmp_path):
    arr = np.random.default_rng(4).integers(0, 2 ** 32, 3 * 1000,
                                            dtype=np.uint64).astype(np.uint32)
    path = str(tmp_path / "p.pages")
    assert native.write_blob(path, arr.reshape(3, 1000))
    np.testing.assert_array_equal(native.read_blob(path), arr)
    np.testing.assert_array_equal(read_pages(path), arr)
    if jnative.get_lib() is not None:
        np.testing.assert_array_equal(jnative.read_blob(path), arr)
    raw = bytearray(Path(path).read_bytes())
    raw[8 + 4 * 17] ^= 0x10
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(IOError, match="crc mismatch in"):
        native.read_blob(path)
    with pytest.raises(IOError, match="crc mismatch in"):
        read_pages(path)
    Path(path).write_bytes(bytes(raw[:100]))
    with pytest.raises(IOError, match="bytes for 3000 pages"):
        native.read_blob(path)
    raw[:8] = (1 << 62).to_bytes(8, "little")    # a corrupt count
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(IOError, match="pages"):
        native.read_blob(path)
    with pytest.raises(IOError):
        native.read_blob(str(tmp_path / "missing.pages"))
    assert not native.write_blob(str(tmp_path / "no" / "dir.pages"), arr)


def test_read_floats_equals_jax(tmp_path):
    _jax_lib()
    w = golden.random_weights(d=8, k_lin=4, d_ffn=16, n_classes=5,
                              max_seq=12, seed=2)
    weights.save_reference_weights(str(tmp_path), w)
    files = sorted(tmp_path.iterdir())
    assert len(files) > 20
    for f in files:
        got = native.read_floats(str(f))
        np.testing.assert_array_equal(got, jnative.read_floats(str(f)))
        np.testing.assert_array_equal(got, weights.read_values(str(f)))
    with pytest.raises(FileNotFoundError):
        native.read_floats(str(tmp_path / "missing.txt"))


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """The codec's build redirected into tmp_path, nothing loaded yet."""
    monkeypatch.setattr(cuda_build, "_BUILD", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    native.get_lib.cache_clear()
    yield tmp_path
    native.get_lib.cache_clear()


def test_build_failure_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(cuda_build, "GXX", str(fresh_build / "no-such-g++"))
    with pytest.raises(RuntimeError, match="cannot run .*no-such-g"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="cannot run"):
        native.crt_lift_center(np.zeros((1, 4), np.uint32), [257])
    # a source the compiler refuses: its message comes with the error
    csrc = fresh_build / "csrc"
    csrc.mkdir()
    (csrc / "fastio.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(cuda_build, "_CSRC", csrc)
    monkeypatch.setattr(cuda_build, "GXX", "g++")
    with pytest.raises(RuntimeError, match=r"fastio.cpp \(rc 1\)(.|\n)*"
                                           r"error"):
        native.get_lib()
    assert not list((fresh_build / "build").glob("*.tmp"))


def test_builds_its_own_library(fresh_build):
    lib = native.get_lib()
    path = Path(lib._name)
    assert path.parent == fresh_build / "build"
    assert path.name.startswith("libfastio-") and path.suffix == ".so"
    assert path == cuda_build.library_path("fastio")
    assert cuda_build.build(("fastio",))["fastio"]["seconds"] == 0.0


@pytest.fixture(scope="module")
def decrypt_env():
    torch.set_num_threads(2)
    params = dict(n=256, scale_bits=26, num_scaling=5, dnum=2, seed=21)
    jctx = JContext(JConfig(**params))
    jkeys = jgenerate_keys(jctx)
    ctx = Context(CKKSConfig(**params), device="cpu")
    a = np.asarray
    keys = convert.keys_from_numpy(
        ctx, jkeys.sk.coeffs, a(jkeys.sk.eval_full), a(jkeys.pk.p0),
        a(jkeys.pk.p1), (a(jkeys.relin.b), a(jkeys.relin.a)), {})
    return JEvaluator(jctx, jkeys), Evaluator(ctx, keys)


@pytest.mark.parametrize("crt_limbs", [1, 3, 5])
def test_decrypt_equals_jax(decrypt_env, crt_limbs):
    """decrypt and decrypt_host lift through the native lifter and equal
    the JAX package's decrypt in float64, and the Python-int lift's
    decode."""
    jev, ev = decrypt_env
    m = np.random.default_rng(crt_limbs).uniform(-1, 1, (6, 128))
    jct = jev.encrypt(m, batch=True, nl=5)
    # a (2, 3) batch in the port: one lift over both axes
    to = lambda c: np.asarray(c).reshape(2, 3, 5, 256)
    ct = convert.ciphertext_from_numpy(ev.ctx, to(jct.c0), to(jct.c1),
                                       jct.nl, jct.scale)
    m = m.reshape(2, 3, 128)
    want = np.asarray(jev.decrypt(jct, crt_limbs=crt_limbs)).reshape(2, 3,
                                                                     128)
    got = ev.decrypt(ct, crt_limbs=crt_limbs)
    assert got.shape == want.shape == (2, 3, 128)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ev.decrypt_host(ct, crt_limbs=crt_limbs),
                                  want)
    np.testing.assert_allclose(np.real(got), m, atol=1e-3)
    # the plain version: the Python-int lift, ciphertext by ciphertext
    k = min(crt_limbs, ct.nl)
    coeffs = ev._coeff_residues(ev.drop_to(ct, k), "decrypt").numpy()
    plain = np.stack([ev.encoder.decode(exact_lift(c, ev.ctx.qs[:k]),
                                        ct.scale)
                      for c in coeffs.reshape(-1, k, 256)])
    np.testing.assert_array_equal(got.reshape(-1, 128), plain)
