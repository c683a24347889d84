"""The port's NTT at ring 2^16, the ring of preset linformer-128c.

The plain version (`ntt.fwd_plain` / `inv_plain`) against the JAX
package's XLA four-step (`ops.ntt._fwd/_inv`), bit-exact, on one batch
entry of 2 limbs; `ntt_cuda.fwd_phased_plain` / `inv_phased_plain`, the
int64 mirrors of K1's and K2's schedules, against the plain version at
2^16, where phase 1 has five stages, a block 1024 threads and the exchange
skew is 5; and the ring limits of the CUDA wrappers (2^16 taken, 2^17
refused).  chip_smoke.py holds the kernels against the plain version on
the card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fhe_linformer_tpu.ops.ntt import NttContext, _fwd, _inv
from fhe_linformer_tpu.primes import ntt_primes
from fhe_linformer_tpu_torch.ops import ntt, ntt_cuda

N = 1 << 16
L = 2


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(2)
    qs = ntt_primes(2 * N, L)
    rng = np.random.default_rng(16)
    x = np.stack([rng.integers(0, q, N, dtype=np.uint32) for q in qs])[None]
    return ntt.NttTables(N, qs, "cpu"), NttContext(N, qs), x


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_plain_matches_jax_n2_16(case, direction):
    tables, jctx, x = case
    port, ref = (ntt.fwd, _fwd) if direction == "fwd" else (ntt.inv, _inv)
    got = port(torch.from_numpy(x.astype(np.int32)), tables, tuple(range(L)))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32),
                                  np.asarray(ref(jnp.asarray(x), jctx.full)))


@pytest.mark.parametrize("direction", ["fwd", "inv"])
def test_schedule_mirrors_n2_16(case, direction):
    tables, _, x = case
    xt = torch.from_numpy(x.astype(np.int32))
    mirror, plain = ((ntt_cuda.fwd_phased_plain, ntt.fwd_plain)
                     if direction == "fwd" else
                     (ntt_cuda.inv_phased_plain, ntt.inv_plain))
    limbs = tuple(range(L))
    np.testing.assert_array_equal(mirror(xt, tables, limbs).numpy(),
                                  plain(xt, tables, limbs).numpy())


def test_ring_limits():
    """K1/K2 are built for rings 2^1 to 2^16 (the two-block layout from
    2^11): a CPU tensor at 2^16 gets as far as the device check, one at
    2^17 is refused for its ring, as is the mirrors' layout."""
    assert ntt_cuda.MAX_LOGN == 16
    ntt_cuda.check_ring(16)
    ntt_cuda.check_ring(16, ntt_cuda.MIN_LOGN)
    for lowest in (ntt_cuda.SMALL_MIN_LOGN, ntt_cuda.MIN_LOGN):
        with pytest.raises(ValueError, match="above K1"):
            ntt_cuda.check_ring(17, lowest)
    for n, match in ((1 << 16, "CUDA tensor"), (1 << 17, "above K1")):
        t = ntt.NttTables(n, ntt_primes(2 * n, 1), "cpu")
        x = torch.zeros((1, n), dtype=torch.int32)
        for kernel in (ntt_cuda.fwd, ntt_cuda.inv):
            with pytest.raises(ValueError, match=match):
                kernel(x, t, (0,))
    with pytest.raises(ValueError, match="above K1"):
        ntt_cuda.fwd_phased_plain(torch.zeros((1, 1 << 17), dtype=torch.int32),
                                  t, (0,))
