"""The port's exact host reference (fhe_linformer_tpu_torch/reference.py)
against the JAX package's, bit for bit, at n <= 2^10 on the port's primes,
and the port's NttPlan against the port's plain NTT (ops/ntt.py) on the
same limbs."""

import numpy as np
import pytest
import torch

from fhe_linformer_tpu import reference as jref
from fhe_linformer_tpu_torch import reference as ref
from fhe_linformer_tpu_torch.ops import ntt
from fhe_linformer_tpu_torch.primes import ntt_primes

SIZES = [8, 256, 1024]


@pytest.mark.parametrize("n", [2, 8, 256, 1024])
def test_bit_reverse_perm(n):
    np.testing.assert_array_equal(ref.bit_reverse_perm(n),
                                  jref.bit_reverse_perm(n))


@pytest.mark.parametrize("n", SIZES)
def test_ntt_plan_tables_and_transforms(n):
    rng = np.random.default_rng(n)
    for q in ntt_primes(2 * n, 2):
        plan, jplan = ref.NttPlan(n, q), jref.NttPlan(n, q)
        for attr in ("psi", "psi_inv", "omega", "omega_inv", "n_inv"):
            assert getattr(plan, attr) == getattr(jplan, attr), attr
        np.testing.assert_array_equal(plan.twist, jplan.twist)
        np.testing.assert_array_equal(plan.untwist, jplan.untwist)
        x = rng.integers(0, q, (3, n), dtype=np.int64)
        X = plan.fwd(x)
        np.testing.assert_array_equal(X, jplan.fwd(x))
        np.testing.assert_array_equal(plan.inv(X), jplan.inv(X))
        np.testing.assert_array_equal(plan.inv(X), x)


@pytest.mark.parametrize("n", SIZES)
def test_ntt_plan_equals_the_plain_ntt(n):
    """NttPlan limb by limb against ops/ntt's plain int64 forward and
    inverse NTT over the same basis."""
    qs = ntt_primes(2 * n, 3)
    tables = ntt.NttTables(n, qs, "cpu")
    x = np.random.default_rng(7).integers(0, min(qs), (2, len(qs), n),
                                          dtype=np.int64)
    X = ntt.fwd_plain(torch.from_numpy(x).int(), tables,
                      tuple(range(len(qs)))).numpy()
    back = ntt.inv_plain(torch.from_numpy(X), tables,
                         tuple(range(len(qs)))).numpy()
    for i, q in enumerate(qs):
        plan = ref.NttPlan(n, q)
        np.testing.assert_array_equal(X[:, i], plan.fwd(x[:, i]))
        np.testing.assert_array_equal(back[:, i], plan.inv(X[:, i]))


def test_negacyclic_mul_naive():
    n = 64
    q = ntt_primes(2 * n, 1)[0]
    rng = np.random.default_rng(1)
    a, b = (rng.integers(0, q, n, dtype=np.int64) for _ in range(2))
    got = ref.negacyclic_mul_naive(a, b, q)
    np.testing.assert_array_equal(got, jref.negacyclic_mul_naive(a, b, q))
    plan = ref.NttPlan(n, q)      # the product the NTT diagonalises
    np.testing.assert_array_equal(got, plan.inv(plan.fwd(a) * plan.fwd(b)
                                                % q))


def test_rns_round_trip():
    qs = ntt_primes(512, 4)
    Q = int(np.prod([int(q) for q in qs], dtype=object))
    rng = np.random.default_rng(2)
    x = np.asarray([int(v) * (Q // 2 ** 31) + int(w) for v, w in zip(
        rng.integers(-2 ** 30, 2 ** 30, 50), rng.integers(0, 2 ** 40, 50))],
        dtype=object)
    res = ref.to_rns(x, qs)
    np.testing.assert_array_equal(res, jref.to_rns(x, qs))
    back = ref.from_rns(res, qs)
    assert back.dtype == object
    np.testing.assert_array_equal(back, jref.from_rns(res, qs))
    np.testing.assert_array_equal(back, x)
