"""The port's modular arithmetic (fhe_linformer_tpu_torch.ops.modarith)
against the JAX package's, bit-exact, on random residues from numpy.

Shoup inputs include lazy values up to 2**32, which the JAX version
accepts and the port computes in int64."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_linformer_tpu.ops import modarith as jma
from fhe_linformer_tpu.primes import ntt_primes, scaling_primes
from fhe_linformer_tpu_torch.ops import modarith as tma

N = 4096
QS = ntt_primes(2 * 1024, 3) + scaling_primes(2 * 1024, 3, 26)


@pytest.fixture(scope="module")
def operands():
    rng = np.random.default_rng(21)
    q = np.asarray(QS, np.int64).reshape(-1, 1)
    a = np.stack([rng.integers(0, int(p), N) for p in QS]).astype(np.int64)
    b = np.stack([rng.integers(0, int(p), N) for p in QS]).astype(np.int64)
    lazy = rng.integers(0, 1 << 32, (len(QS), N), dtype=np.int64)
    # the edges: 0, q-1 and the largest lazy input
    a[:, 0], b[:, 0], lazy[:, 0] = 0, 0, 0
    a[:, 1], b[:, 1], lazy[:, 1] = (q[:, 0] - 1,) * 2 + ((1 << 32) - 1,)
    return q, a, b, lazy


def _j(x):
    return jnp.asarray(np.asarray(x).astype(np.uint32))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.int64))


def test_barrett_mulmod(operands):
    q, a, b, _ = operands
    params = [jma.barrett_params(int(p)) for p in q[:, 0]]
    mu = np.asarray([m for _, m, _ in params], np.int64).reshape(-1, 1)
    sh = np.asarray([s for _, _, s in params], np.int64).reshape(-1, 1)
    assert [tma.barrett_params(int(p)) for p in q[:, 0]] == params
    want = np.asarray(jma.barrett_mulmod(_j(a), _j(b), _j(q), _j(mu), _j(sh)))
    got = tma.barrett_mulmod(_t(a).int(), _t(b).int(), _t(q), _t(mu), _t(sh))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    np.testing.assert_array_equal(tma.mulmod(_t(a).int(), _t(b), _t(q)).numpy(),
                                  want.astype(np.int64))


def test_shoup_mulmod_lazy_inputs(operands):
    q, a, b, lazy = operands
    w = b[:, :1]                                  # one constant per limb
    ws = jma.shoup_precompute(w, q)
    np.testing.assert_array_equal(tma.shoup_precompute(w, q), ws)
    for x in (a, lazy):
        want = np.asarray(jma.shoup_mulmod(_j(x), _j(w), jnp.asarray(ws),
                                           _j(q)))
        got = tma.shoup_mulmod(_t(x), _t(w), _t(ws.astype(np.int64)), _t(q))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    # int32 storage of the companion (uint32 bits) reads the same
    got32 = tma.shoup_mulmod(_t(a).int(), _t(w).int(),
                             torch.from_numpy(ws.view(np.int32)), _t(q).int())
    np.testing.assert_array_equal(
        got32.numpy().astype(np.uint32),
        np.asarray(jma.shoup_mulmod(_j(a), _j(w), jnp.asarray(ws), _j(q))))


@pytest.mark.parametrize("op", ["addmod", "submod"])
def test_add_sub(operands, op):
    q, a, b, _ = operands
    want = np.asarray(getattr(jma, op)(_j(a), _j(b), _j(q)))
    got = getattr(tma, op)(_t(a).int(), _t(b).int(), _t(q).int())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_negmod(operands):
    q, a, _, _ = operands
    want = np.asarray(jma.negmod(_j(a), _j(q)))
    got = tma.negmod(_t(a).int(), _t(q).int())
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
