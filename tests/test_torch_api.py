"""The public API points the port added last, against the JAX package's:
Gadgets.relu at its default degree (its bit-exact check against the JAX
package shares the JAX compiles of the GELU gadget's in
tests/test_torch_circuit_packed.py), cheb_eval, encode_matrix_dense,
Context.auto_coeff, Timers.time / report, the `ckks`, `boot` and `poly`
package exports, and each one's signature."""

import importlib
import inspect
import time

import numpy as np
import pytest
import torch

from fhe_linformer_tpu.boot import transform as jtf
from fhe_linformer_tpu.ckks import CKKSConfig as JConfig, Context as JContext
from fhe_linformer_tpu.poly import cheb as jcheb
from fhe_linformer_tpu.utils import timing as jtiming
from fhe_linformer_tpu_torch.boot import transform as tf
from fhe_linformer_tpu_torch.ckks import (CKKSConfig, Context, Evaluator,
                                          generate_keys)
from fhe_linformer_tpu_torch.poly import Gadgets, cheb, cheb_eval
from fhe_linformer_tpu_torch.poly.gadgets import relu_degree_depth
from fhe_linformer_tpu_torch.utils import timing

PARAMS = dict(n=256, scale_bits=26, num_scaling=12, dnum=3, seed=13)


@pytest.fixture(scope="module")
def ev():
    torch.set_num_threads(2)
    ctx = Context(CKKSConfig(**PARAMS), device="cpu")
    return Evaluator(ctx, generate_keys(ctx))


def test_relu_default_degree(ev):
    """The default degree 119 within its depth (RELU_DEPTH: 10), and the
    decrypt against cheb_eval of the same fit and against max(x, 0)."""
    z = np.random.default_rng(3).uniform(-1, 1, (2, 128))
    ct = ev.encrypt(z, batch=True)
    out = Gadgets(ev).relu(ct)
    assert 0 < ct.nl - out.nl <= relu_degree_depth(119) == 10
    coeffs = cheb.chebyshev_fit(lambda x: np.maximum(x, 0.0), -1.0, 1.0, 119)
    x = np.real(ev.decrypt(ct))
    got = np.real(ev.decrypt(out))
    np.testing.assert_allclose(got, cheb_eval(coeffs, x), atol=5e-3)
    np.testing.assert_allclose(got, np.maximum(x, 0), atol=0.05)


def test_cheb_eval_equals_jax():
    rng = np.random.default_rng(1)
    c = rng.normal(size=31)
    y = rng.uniform(-1, 1, 200)
    np.testing.assert_array_equal(cheb_eval(c, y), jcheb.cheb_eval(c, y))


@pytest.mark.parametrize("n", [16, 64])
def test_encode_matrix_dense_equals_jax(n):
    got = tf.encode_matrix_dense(n)
    assert got.shape == (n // 2, n // 2)
    np.testing.assert_array_equal(got, jtf.encode_matrix_dense(n))


def test_auto_coeff_equals_jax(ev):
    jctx = JContext(JConfig(**PARAMS))
    x = np.random.default_rng(6).integers(-2 ** 40, 2 ** 40, 256)
    for t in (ev.ctx.galois_t(1), ev.ctx.galois_t(-3), ev.ctx.conj_t()):
        got = ev.ctx.auto_coeff(x, t)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got, jctx.auto_coeff(x, t))


def test_timers_equal_jax(monkeypatch):
    """Timers.time adds a block's seconds to totals and one to counts,
    also when the block raises; report has the JAX package's format."""
    reports = []
    for mod in (timing, jtiming):
        ticks = iter([10.0, 10.25, 20.0, 20.5, 30.0, 30.123456])
        monkeypatch.setattr(time, "perf_counter", lambda it=ticks: next(it))
        t = mod.Timers()
        for _ in range(2):
            with t.time("a"):
                pass
        with pytest.raises(ValueError):
            with t.time("b"):
                raise ValueError
        t.count("keyswitch", 3)
        monkeypatch.undo()
        reports.append(t.report())
    assert reports[0] == reports[1] == {
        "a": {"total_s": 0.75, "count": 2},
        "b": {"total_s": 0.1235, "count": 1},
        "keyswitch": {"count": 3}}


@pytest.mark.parametrize("package", ["ckks", "boot", "poly"])
def test_package_exports_equal_jax(package):
    port = importlib.import_module(f"fhe_linformer_tpu_torch.{package}")
    ref = importlib.import_module(f"fhe_linformer_tpu.{package}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        assert getattr(port, name).__module__.startswith(
            f"fhe_linformer_tpu_torch.{package}.")


@pytest.mark.parametrize("module,cls,name", [
    ("poly.gadgets", "Gadgets", "relu"), ("poly.cheb", None, "cheb_eval"),
    ("boot.transform", None, "encode_matrix_dense"),
    ("ckks.context", "Context", "auto_coeff"),
    ("utils.timing", "Timers", "time"), ("utils.timing", "Timers", "report")])
def test_signatures_equal_jax(module, cls, name):
    def resolve(package):
        obj = importlib.import_module(f"{package}.{module}")
        return getattr(getattr(obj, cls) if cls else obj, name)
    port = resolve("fhe_linformer_tpu_torch")
    ref = resolve("fhe_linformer_tpu")
    assert str(inspect.signature(port)) == str(inspect.signature(ref))
